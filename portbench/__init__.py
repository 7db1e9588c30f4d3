"""The PyTorch + CUDA port's benchmark: one command runs one cell
(``python3 portbench/run.py --workload <cell> ...``); see README.md."""
