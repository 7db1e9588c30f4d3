from .pipeline import DataConfig, SyntheticLM, batch_for
