"""The harness's own tests: ``python -m pytest bench/tests`` from the root
of the repository.  Card tests carry ``requires_cuda`` and skip without
one."""
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH / "tests"), str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
