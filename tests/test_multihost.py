"""Multi-host CLI run: a 2-process virtual CPU cluster over one SAM stream.

Each process owns 4 virtual CPU devices (a data mesh) and a stride of
the SAM lines, writes its own TSV shard, and the shards concatenate to
the complete result — the reference's unordered-collector semantics
(reference scripts/STRique.py:778-802) scaled across hosts via
jax.distributed.  This drives the REAL product path end-to-end:
cli.cmd_count -> init_distributed(coordinator) -> local data mesh ->
bucket-stream scheduler -> per-host shard files.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from strique_tpu.pore_model import PoreModel

from test_pipeline import MODEL, PREFIX, REPEAT, SUFFIX, make_single_f5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_cli_count(tmp_path):
    pm = PoreModel(MODEL)
    rng = np.random.default_rng(21)
    backbone = "".join(rng.choice(list("ACTG"), 800))
    counts = {f"read-{i}": n for i, n in enumerate((8, 13, 17, 21))}
    for rid, n in counts.items():
        seq = backbone[:400] + PREFIX + REPEAT * n + SUFFIX + backbone[-400:]
        sig = pm.generate_signal(seq, samples=8)
        make_single_f5(tmp_path / f"{rid}.fast5", rid, (sig * 10).astype(np.int16))
    from strique_tpu.io import fast5

    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(fast5.index(str(tmp_path))) + "\n")
    repeat_tsv = tmp_path / "repeats.tsv"
    repeat_tsv.write_text(
        "chr\tbegin\tend\tname\trepeat\tprefix\tsuffix\n"
        f"chr9\t27573527\t27573544\tc9orf72\t{REPEAT}\t{PREFIX}\t{SUFFIX}\n")
    sam = tmp_path / "algn.sam"
    rows = ["@HD\tVN:1.6"]
    for rid in counts:
        rows.append(f"{rid}\t0\tchr9\t27541232\t60\t40000M\t*\t0\t0\t*\t*")
    sam.write_text("\n".join(rows) + "\n")

    out = tmp_path / "out.tsv"
    port = _free_port()
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORM_NAME": "cpu",
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    })
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "strique_tpu.cli", "count", str(fofn), MODEL,
             str(repeat_tsv), "--algn", str(sam), "--out", str(out),
             "--coordinator", f"localhost:{port}", "--num_hosts", "2",
             "--host_id", str(i), "--batch", "4", "--log_level", "info"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    logs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, se.decode()[-2000:]

    # rank 0 merges the .partN shards into --out after the barrier: the
    # user gets ONE file (the reference's single-collector contract,
    # scripts/STRique.py:778-802), parts cleaned up
    assert out.exists(), "merged output missing"
    assert not (tmp_path / "out.tsv.part0").exists()
    assert not (tmp_path / "out.tsv.part1").exists()
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("ID\t")
    rows = [l.split("\t") for l in lines[1:]]
    # each read counted exactly once, exact counts
    assert sorted(r[0] for r in rows) == sorted(counts)
    for r in rows:
        assert int(r[3]) == counts[r[0]], f"{r[0]}: {r[3]} != {counts[r[0]]}"
    # the SAM stride actually split the work 2/2 between the processes
    for _, se in logs:
        assert "Processed 2 alignments" in se.decode()
