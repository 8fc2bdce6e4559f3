"""The port's host allocator tuning (`utils/malloc.py`) against the JAX
package's, and its place at the start of the port's command line."""
import pytest

from locityper_tpu.utils import malloc as jmalloc
from locityper_tpu_torch import cli
from locityper_tpu_torch.utils import malloc


@pytest.mark.parametrize("name", ["M_TRIM_THRESHOLD", "M_MMAP_THRESHOLD",
                                  "M_MMAP_MAX"])
def test_constants_equal_reference(name):
    assert getattr(malloc, name) == getattr(jmalloc, name)


def test_tuning_applies_and_is_idempotent():
    assert malloc.tune_host_allocator() is True
    assert malloc.tune_host_allocator() is True


def test_cli_tunes_before_parsing(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(malloc, "tune_host_allocator",
                        lambda: calls.append(1) or True)
    with pytest.raises(SystemExit) as exit_:
        cli.main(["--help"])
    assert exit_.value.code == 0
    assert calls == [1]
    assert "locityper-tpu-torch" in capsys.readouterr().out
