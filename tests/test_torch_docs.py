"""``docs/execution-spec.md``'s examples hold for the port.

Every fenced ```python block of the page runs as a doctest with
``repro.`` read as ``repro_torch.``, in one namespace shared across the
blocks and with the repo root as cwd (``ExecutionSpec.load(
"examples/moe-spec.json")``), as ``tests/test_docs.py`` runs them against
the reference.  The page itself names the reference.
"""
import doctest
import os
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PAGE = REPO / "docs" / "execution-spec.md"
_FENCE_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)
_REF_RE = re.compile(r"\brepro\.")


def test_execution_spec_examples_hold_for_the_port():
    blocks = [_REF_RE.sub("repro_torch.", b)
              for b in _FENCE_RE.findall(PAGE.read_text())]
    assert blocks and any("repro_torch." in b for b in blocks)
    parser = doctest.DocTestParser()
    runner = doctest.DocTestRunner(
        optionflags=doctest.ELLIPSIS | doctest.IGNORE_EXCEPTION_DETAIL)
    globs: dict = {}
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        for i, block in enumerate(blocks):
            test = parser.get_doctest(block, globs,
                                      f"execution-spec.md[block {i}]",
                                      None, None)
            runner.run(test, clear_globs=False)
            globs = test.globs
    finally:
        os.chdir(cwd)
    assert runner.tries >= 15
    assert runner.failures == 0, (
        f"{runner.failures} doctest failure(s) in docs/execution-spec.md "
        "against repro_torch (run pytest -s to see the diffs)")
