"""The machine-dependent decisions: implementations, batch, cache path,
launch width, and which cards a process of a one-machine run opens."""
import os
import types

import pytest

from strique_tpu import platform


def test_cpu_runs_the_plain_references():
    assert platform.platform() == "cpu"
    assert not platform.use_cuda()
    assert platform.align_impl() == "xla"
    assert platform.viterbi_impl() == "xla"


@pytest.mark.parametrize("kind, sms, want", [
    ("gpu", 132, 72),   # H100 SXM: 66 reads -> 132 (read, flank) rows, rounded to 8
    ("gpu", 114, 64),   # H100 PCIe
    ("gpu", 16, 8),
    ("gpu", None, platform.CPU_BATCH),
    ("cpu", 8, platform.CPU_BATCH),
])
def test_default_batch_covers_sms(kind, sms, want):
    dev = types.SimpleNamespace(platform=kind, core_count=sms)
    assert platform.default_batch([dev]) == want


def test_gpu_picks_cuda(monkeypatch):
    monkeypatch.setattr(platform, "platform", lambda: "gpu")
    assert platform.align_impl() == "cuda" and platform.viterbi_impl() == "cuda"


def test_compile_cache_rule(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert platform.compile_cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert platform.compile_cache_dir() == os.path.join(platform.CHECKOUT, ".jax_cache")


def test_checkout_is_repo_root():
    assert os.path.isfile(os.path.join(platform.CHECKOUT, "strique_tpu", "platform.py"))


def test_launch_rows_fit_the_pointer_budget(monkeypatch):
    per_row = platform.ptr_row_bytes(24576, 896)
    assert per_row == -(-(24576 + 896) // 8) * 896 * 4
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(10.5 * per_row / (1 << 30)))
    assert platform.launch_rows(128, 24576, 896) == 10
    assert platform.launch_rows(4, 24576, 896) == 4


def test_over_budget_read_raises(monkeypatch):
    """One row whose plane alone exceeds the budget is an error naming the
    read length and the budget, not an out-of-memory crash."""
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.5")
    with pytest.raises(ValueError, match=r"4000000-sample read .* 0\.50 GiB"):
        platform.launch_rows(2, 4_000_000, 1024)


@pytest.mark.parametrize("coordinator, n_proc, pid, platforms, want", [
    ("localhost:1234", 2, 1, None, [2, 3]),       # two processes on one 4-card machine
    ("127.0.0.1:1234", 4, 0, "cuda", [0]),
    ("[::1]:1234", 2, 0, None, [0, 1]),
    ("node7:1234", 2, 1, None, None),             # processes on separate hosts keep all cards
    ("localhost:1234", 2, 1, "cpu", None),        # not a GPU run
    ("localhost:1234", 8, 1, None, None),         # fewer cards than processes
    ("localhost:1234", 1, 0, None, None),         # a single process
    (None, 2, 1, None, None),
])
def test_one_machine_processes_split_the_cards(monkeypatch, coordinator, n_proc, pid,
                                                platforms, want):
    from strique_tpu.parallel.mesh import _local_gpu_ids

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    assert _local_gpu_ids(coordinator, n_proc, pid) == want
