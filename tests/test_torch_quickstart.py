"""``examples/quickstart_torch.py`` on the CPU for every architecture:
forward, three train steps and eight decode steps of the reduced config
(with the vision patches or the encoder's frames), finite, in range."""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config

_PATH = Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


def _quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def threads():
    """Two CPU threads (tiny shapes: more only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quickstart_runs_every_arch(arch, capsys, threads):
    torch.manual_seed(0)
    out = _quickstart().main(["--arch", arch, "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "decoded token ids" in text
    losses = [float(line.split("loss=")[1]) for line in text.splitlines()
              if line.startswith("train step")]
    assert len(losses) == 3 and all(0.0 < v < 20.0 for v in losses)
    vocab = reduced_config(get_config(arch)).padded_vocab
    assert len(out) == 9 and all(0 <= t < vocab for t in out)
