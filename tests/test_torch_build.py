"""The port's kernel build (nos_tpu_torch/ops/_build.py) and the kernels'
timing tools (ops/flash_fwd_bench.py, ops/flash_bwd_bench.py) on the CPU.

No nvcc here: these tests exercise what needs none. A library's cache
key hashes its source, every ``csrc/*.cuh`` header and the nvcc flags,
so an edited header rebuilds every kernel and an unrelated file does
not; the ptxas report parser reads registers and spills per entry.
"""
import pytest

from nos_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "kern.cu").write_text('#include "ring.cuh"\nextern "C" int f() { return 0; }\n')
    (root / "ring.cuh").write_text("// ring v1\n")
    monkeypatch.setattr(_build, "CSRC", root)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return root


def test_library_path_is_stable_and_named_after_the_kernel(csrc):
    first = _build.library_path("kern")
    assert first == _build.library_path("kern")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libkern-") and first.suffix == ".so"


def test_editing_a_header_changes_the_library_path(csrc):
    before = _build.library_path("kern")
    (csrc / "ring.cuh").write_text("// ring v2\n")
    assert _build.library_path("kern") != before


def test_adding_a_header_changes_the_library_path(csrc):
    before = _build.library_path("kern")
    (csrc / "extra.cuh").write_text("// another header\n")
    assert _build.library_path("kern") != before


def test_editing_an_unrelated_file_keeps_the_library_path(csrc, tmp_path):
    before = _build.library_path("kern")
    (csrc / "notes.txt").write_text("not a header\n")
    (csrc / "other.cu").write_text("// another kernel's source\n")
    (tmp_path / "ring.cuh").write_text("// outside csrc\n")
    assert _build.library_path("kern") == before


def test_editing_the_source_or_the_flags_changes_the_library_path(csrc, monkeypatch):
    before = _build.library_path("kern")
    (csrc / "kern.cu").write_text('#include "ring.cuh"\nextern "C" int f() { return 1; }\n')
    edited = _build.library_path("kern")
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("kern") != edited


def test_every_port_kernel_is_keyed_on_the_shared_hopper_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "sm90.cuh" in headers
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert '#include "sm90.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
        assert _build.library_path(name).name.startswith(f"lib{name}-")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 512 bytes cmem[0]
"""


def test_parse_ptxas_log_reads_registers_and_spills_per_entry():
    report = _build.parse_ptxas_log(PTXAS_LOG)
    assert report == {
        "_Z6kernelILi128EEvv": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "_Z6kernelILi64EEvv": {"registers": 128, "spill_stores": 24, "spill_loads": 16},
    }


def test_ptxas_report_reads_the_log_beside_the_library(csrc):
    _build.BUILD_DIR.mkdir()
    (_build.BUILD_DIR / f"{_build.library_path('kern').stem}.log").write_text(PTXAS_LOG)
    assert set(_build.ptxas_report("kern")) == {"_Z6kernelILi128EEvv", "_Z6kernelILi64EEvv"}


def test_flash_fwd_bench_refuses_without_a_card(capsys):
    import torch

    from nos_tpu_torch.ops import flash_fwd_bench

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is what is tested")
    assert flash_fwd_bench.main(["--shapes", "1x128xc"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_flash_bwd_bench_refuses_without_a_card(capsys):
    import torch

    from nos_tpu_torch.ops import flash_bwd_bench

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is what is tested")
    assert flash_bwd_bench.main(["--shapes", "1x128xc"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_flash_bwd_source_has_no_mma_sync_and_no_atomics():
    """The backward kernels run every product on wgmma and give each
    output element one owner (no atomics); the header's forms check
    builds beside them but is not a kernel of the port's paths."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "mma.sync" not in code and "atomic" not in code
    assert "wgmma" in code and "tma_load" in code
    assert "sm90_check" not in _build.KERNELS


@pytest.mark.parametrize("spec,heads", [("32x8x128", (32, 8, 128)), ("8x1x256", (8, 1, 256))])
def test_bench_heads_option(spec, heads):
    """Both benches time Llama-3-8B's heads by default and any
    ``HQxHKVxHD`` (Gemma-2B's is 8x1x256) with ``--heads``."""
    from nos_tpu_torch.ops import flash_bwd_bench, flash_fwd_bench

    assert flash_fwd_bench.parse_heads(spec) == heads
    assert flash_bwd_bench.parse_heads is flash_fwd_bench.parse_heads
    assert flash_fwd_bench.parse_heads(f"{flash_fwd_bench.HQ}x{flash_fwd_bench.HKV}x"
                                       f"{flash_fwd_bench.HD}") == (32, 8, 128)


def test_device_ms_retakes_a_profile_that_recorded_nothing(monkeypatch):
    """torch.profiler now and then drops a window and records no device
    event: device_ms takes the profile again, and reports None (not
    measured), never 0, if every attempt came back empty."""
    import types

    import torch
    import torch.profiler

    from nos_tpu_torch.util import cuda_timing

    cuda = torch.autograd.DeviceType.CUDA
    windows = []

    class FakeProfile:
        def __init__(self, activities):
            self.events = windows.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [types.SimpleNamespace(device_type=cuda, self_device_time_total=us)
                    for us in self.events]

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []
    windows[:] = [[], [300.0, 100.0]]
    assert cuda_timing.device_ms(lambda: calls.append(1), reps=4) == 0.1
    assert len(calls) == 1 + 2 * 4 and windows == []
    windows[:] = [[], [], []]
    assert cuda_timing.device_ms(lambda: None, reps=4) is None
