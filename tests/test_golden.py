"""Golden-file end-to-end test against the reference's published output.

The reference documents the expected result of its bundled dataset
(reference docs/installation/test.md:16): read ce47b364-..., target
c9orf72, strand -, count 735, scores 6.3156/6.0319, log_p -119860.52,
offset 1633, ticks 40758.  See PARITY.md for the precision contract:
offset/ticks must be exact, count within +-2, scores within 1%.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

# a checkout of the reference repository (its data/, models/ and configs/);
# the bundled read and the r9.4 models are not redistributed with this repo
REFERENCE = os.environ.get("STRIQUE_REFERENCE_DIR", "")
DATA = os.path.join(REFERENCE, "data")
MODEL = os.path.join(REFERENCE, "models", "r9_4_450bps.model")
MOD_MODEL = os.path.join(REFERENCE, "models", "r9_4_450bps_mCpG.model")
REPEAT_TSV = os.path.join(REFERENCE, "configs", "repeat_config.tsv")
PARAMS_JSON = os.path.join(REFERENCE, "configs", "STRique.json")

GOLDEN = {
    "ID": "ce47b364-ed6e-4409-808a-1041c0b5aac2",
    "target": "c9orf72",
    "strand": "-",
    "count": 735,
    "score_prefix": 6.3155927807600545,
    "score_suffix": 6.031860427335506,
    "log_p": -119860.52066647023,
    "offset": 1633,
    "ticks": 40758,
}


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    if not (REFERENCE and os.path.isfile(os.path.join(DATA, "c9orf72.fast5"))):
        pytest.skip("needs the reference's bundled read data/c9orf72.fast5 and its r9.4 "
                    "pore models (set STRIQUE_REFERENCE_DIR to a STRique checkout)")
    d = tmp_path_factory.mktemp("golden")
    shutil.copy(os.path.join(DATA, "c9orf72.fast5"), d)
    return d


def test_golden_count_pipeline(golden_dir):
    from strique_tpu.cli import main

    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["index", str(golden_dir)])
    fofn = golden_dir / "reads.fofn"
    fofn.write_text(buf.getvalue())
    assert GOLDEN["ID"] in buf.getvalue()

    out = golden_dir / "counts.tsv"
    # single device: this asserts numeric parity; mesh byte-identity to the
    # single-device path is covered by test_cli_mesh (and the 1-read batch
    # would pad to 7 dummy shards on the virtual 8-CPU mesh)
    rc = main(["count", str(fofn), MODEL, REPEAT_TSV,
               "--algn", os.path.join(DATA, "c9orf72.sam"),
               "--config", PARAMS_JSON, "--out", str(out), "--devices", "1"])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 2
    cols = lines[1].split("\t")
    assert cols[0] == GOLDEN["ID"]
    assert cols[1] == GOLDEN["target"]
    assert cols[2] == GOLDEN["strand"]
    count, sp, ss, logp = int(cols[3]), float(cols[4]), float(cols[5]), float(cols[6])
    offset, ticks = int(cols[7]), int(cols[8])
    assert offset == GOLDEN["offset"]  # exact: alignment warp parity
    assert ticks == GOLDEN["ticks"]  # exact
    assert abs(count - GOLDEN["count"]) <= 2  # PARITY.md deviation 2
    assert abs(sp - GOLDEN["score_prefix"]) / GOLDEN["score_prefix"] < 0.01
    assert abs(ss - GOLDEN["score_suffix"]) / GOLDEN["score_suffix"] < 0.01
    assert abs(logp - GOLDEN["log_p"]) / abs(GOLDEN["log_p"]) < 0.02
    assert cols[9] == "-"


def test_golden_count_pipeline_compat(golden_dir):
    """The opt-in pomegranate_compat mode is pinned too: the framework's
    DEFAULT is the literal-graph semantics (documented in PARITY.md), and
    this asserts the compat mode's documented golden outputs (count 734,
    log_p -119864.6) so neither semantics can drift unnoticed."""
    import json

    from strique_tpu.cli import main

    fofn = golden_dir / "reads.fofn"
    if not fofn.exists():
        pytest.skip("default golden test must run first (module fixture order)")
    with open(PARAMS_JSON) as fp:
        cfg = json.load(fp)
    cfg["HMM"]["pomegranate_compat"] = True
    compat_json = golden_dir / "compat.json"
    compat_json.write_text(json.dumps(cfg))

    out = golden_dir / "counts_compat.tsv"
    rc = main(["count", str(fofn), MODEL, REPEAT_TSV,
               "--algn", os.path.join(DATA, "c9orf72.sam"),
               "--config", str(compat_json), "--out", str(out), "--devices", "1"])
    assert rc == 0
    cols = out.read_text().strip().split("\n")[1].split("\t")
    assert cols[0] == GOLDEN["ID"]
    count, logp = int(cols[3]), float(cols[6])
    offset, ticks = int(cols[7]), int(cols[8])
    assert offset == GOLDEN["offset"] and ticks == GOLDEN["ticks"]
    assert count == 734  # PARITY.md: compat mode golden count
    assert abs(logp - (-119864.6)) < 5.0


# the reference's CI runs the golden count WITH --mod_model
# (reference .travis.yml:102); the mod column on the bundled native-DNA
# read is a deterministic per-repeat-unit 0/1 string.  Pinned from this
# repo's kernels (bit-stable across device tiers): 734 units, 70 called
# methylated (~9.5% — the GGCCCC unit junction carries one CpG).
GOLDEN_MOD_LEN = 734
GOLDEN_MOD_ONES = 70


def _assert_golden_mod_column(mod: str):
    assert mod != "-"
    assert set(mod) <= {"0", "1"}
    assert len(mod) == GOLDEN_MOD_LEN
    assert mod.count("1") == GOLDEN_MOD_ONES


def test_golden_count_pipeline_mod(golden_dir):
    """The reference CI's exact command shape — golden count with
    --mod_model (reference .travis.yml:99-102) — pinning the full row
    INCLUDING the mod column in default count semantics."""
    from strique_tpu.cli import main

    fofn = golden_dir / "reads.fofn"
    if not fofn.exists():
        pytest.skip("default golden test must run first (module fixture order)")
    out = golden_dir / "counts_mod.tsv"
    rc = main(["count", str(fofn), MODEL, REPEAT_TSV,
               "--algn", os.path.join(DATA, "c9orf72.sam"),
               "--config", PARAMS_JSON,
               "--mod_model", MOD_MODEL,
               "--out", str(out), "--devices", "1"])
    assert rc == 0
    cols = out.read_text().strip().split("\n")[1].split("\t")
    assert cols[0] == GOLDEN["ID"]
    assert int(cols[3]) == 733  # PARITY.md default-mode count, unchanged by mod
    assert int(cols[7]) == GOLDEN["offset"] and int(cols[8]) == GOLDEN["ticks"]
    _assert_golden_mod_column(cols[9])


def test_golden_count_pipeline_mod_compat(golden_dir):
    """--mod_model under pomegranate_compat semantics: count 734 and the
    identical mod column (compat only shifts the d1/d2 dummy-visit
    accounting, not the mod unit segmentation on this read)."""
    import json

    from strique_tpu.cli import main

    fofn = golden_dir / "reads.fofn"
    if not fofn.exists():
        pytest.skip("default golden test must run first (module fixture order)")
    with open(PARAMS_JSON) as fp:
        cfg = json.load(fp)
    cfg["HMM"]["pomegranate_compat"] = True
    compat_json = golden_dir / "compat_mod.json"
    compat_json.write_text(json.dumps(cfg))
    out = golden_dir / "counts_mod_compat.tsv"
    rc = main(["count", str(fofn), MODEL, REPEAT_TSV,
               "--algn", os.path.join(DATA, "c9orf72.sam"),
               "--config", str(compat_json),
               "--mod_model", MOD_MODEL,
               "--out", str(out), "--devices", "1"])
    assert rc == 0
    cols = out.read_text().strip().split("\n")[1].split("\t")
    assert int(cols[3]) == 734  # compat-mode golden count
    assert int(cols[7]) == GOLDEN["offset"] and int(cols[8]) == GOLDEN["ticks"]
    assert abs(float(cols[6]) - (-119864.6)) < 5.0
    _assert_golden_mod_column(cols[9])
