"""IO layer tests: fast5 indexing/retrieval/extraction, SAM decoding."""
import os
import shutil
import tarfile

import h5py
import numpy as np
import pytest

from strique_tpu.io import fast5
from strique_tpu.io.sam import SamRecord, decode_cigar, decode_sam, intersect_targets

# the reference's bundled read (data/ of a STRique checkout), not redistributed here
REFERENCE = os.environ.get("STRIQUE_REFERENCE_DIR", "")
DATA_F5 = os.path.join(REFERENCE, "data", "c9orf72.fast5")
GOLD_ID = "ce47b364-ed6e-4409-808a-1041c0b5aac2"


@pytest.fixture
def real_read():
    """Path of the reference's bundled read; skips when it is absent."""
    if not (REFERENCE and os.path.isfile(DATA_F5)):
        pytest.skip("needs the reference's bundled read data/c9orf72.fast5 "
                    "(set STRIQUE_REFERENCE_DIR to a STRique checkout)")
    return DATA_F5


def make_single_f5(path, read_id, signal):
    with h5py.File(path, "w") as f:
        g = f.create_group(f"Raw/Reads/Read_1")
        g.attrs["read_id"] = np.bytes_(read_id.encode())
        g.attrs["duration"] = np.uint32(len(signal))
        g.create_dataset("Signal", data=signal.astype(np.int16))


def test_read_id_single(real_read):
    assert fast5.read_id_single(DATA_F5) == GOLD_ID
    assert not fast5.is_multi_read(DATA_F5)


def test_index_and_get_raw(tmp_path, real_read):
    shutil.copy(DATA_F5, tmp_path)
    lines = list(fast5.index(str(tmp_path)))
    assert lines == [f"c9orf72.fast5\t{GOLD_ID}"]
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    sig = idx.get_raw(GOLD_ID)
    assert sig.dtype == np.int16
    assert len(sig) == 284184


def test_multi_read_roundtrip(tmp_path):
    # build two single fast5s, pack to multi, index, read back
    rng = np.random.default_rng(0)
    sigs = {}
    singles = []
    for i in range(2):
        rid = f"read-{i:04d}-xxxx"
        sig = rng.integers(400, 800, 100 + i * 10).astype(np.int16)
        p = tmp_path / f"single{i}.fast5"
        make_single_f5(p, rid, sig)
        sigs[rid] = sig
        singles.append(str(p))
    bulk = tmp_path / "bulk" / "batch.fast5"
    os.makedirs(bulk.parent)
    fast5.singles_to_multi(singles, str(bulk))
    assert fast5.is_multi_read(str(bulk))
    lines = list(fast5.index(str(bulk.parent)))
    assert len(lines) == 2
    fofn = bulk.parent / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    for rid, sig in sigs.items():
        np.testing.assert_array_equal(idx.get_raw(rid), sig)


def test_tar_archive_index_and_get(tmp_path):
    rid = "tar-read-0001"
    sig = np.arange(50, dtype=np.int16)
    single = tmp_path / "a.fast5"
    make_single_f5(single, rid, sig)
    tar = tmp_path / "batch.tar"
    with tarfile.open(tar, "w") as tf:
        tf.add(single, arcname="a.fast5")
    single.unlink()
    lines = list(fast5.index(str(tmp_path)))
    assert lines == [f"batch.tar/a.fast5\t{rid}"]
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    np.testing.assert_array_equal(idx.get_raw(rid), sig)


def test_set_raw_roundtrip(tmp_path):
    rid = "set-read-0001"
    make_single_f5(tmp_path / "x.fast5", rid, np.arange(64, dtype=np.int16))
    fofn = tmp_path / "reads.fofn"
    fofn.write_text(f"x.fast5\t{rid}\n")
    idx = fast5.Fast5Index(str(fofn))
    new_sig = np.arange(32, dtype=np.int16) * 2
    idx.set_raw(rid, new_sig)
    np.testing.assert_array_equal(idx.get_raw(rid), new_sig)
    with h5py.File(tmp_path / "x.fast5") as f:
        assert f["Raw/Reads/Read_1"].attrs["duration"] == 32


def test_extract_subset(tmp_path):
    rids = [f"xtr-read-{i}" for i in range(3)]
    for i, rid in enumerate(rids):
        make_single_f5(tmp_path / f"s{i}.fast5", rid, np.full(10 + i, i, np.int16))
    lines = list(fast5.index(str(tmp_path)))
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    ids_txt = tmp_path / "subset.txt"
    ids_txt.write_text("\n".join(rids[:2]) + "\n")
    out = tmp_path / "out"
    idx.extract(str(ids_txt), str(out), format="single")
    extracted = sorted(os.listdir(out))
    assert len(extracted) == 2


# --- SAM ------------------------------------------------------------------

def test_decode_cigar():
    assert decode_cigar("2S10M1D3I") == [(2, "S"), (10, "M"), (1, "D"), (3, "I")]


def test_decode_sam_golden_line(real_read):
    sam = os.path.join(os.path.dirname(real_read), "c9orf72.sam")
    line = next(l for l in open(sam) if not l.startswith("@"))
    sr = decode_sam(line)
    assert sr.QNAME == GOLD_ID
    assert sr.FLAG == 16 and sr.strand == "-"
    assert sr.RNAME == "chr9" and sr.POS == 27541232
    assert sr.CLIP_BEGIN == 2
    assert sr.TLEN > 0


def test_decode_sam_malformed():
    assert decode_sam("garbage line").QNAME == ""
    assert decode_sam("a\tb\tc\tnotint\te\tf\tg\th\ti\tj\tk").QNAME == ""


def test_intersect_targets():
    loci = {"chr9": [("c9orf72", 27573527, 27573544)]}
    sr = SamRecord(QNAME="x", RNAME="chr9", POS=27541232, TLEN=40000, CLIP_BEGIN=2, CLIP_END=0)
    assert intersect_targets(sr, loci) == ["c9orf72"]
    sr2 = SamRecord(QNAME="x", RNAME="chr9", POS=27573530, TLEN=100)
    assert intersect_targets(sr2, loci) == []
    sr3 = SamRecord(QNAME="x", RNAME="chr1", POS=27541232, TLEN=40000)
    assert intersect_targets(sr3, loci) == []


def test_tar_extract_exact_member_match(tmp_path):
    """A member path that is a substring of another must not over-extract."""
    sigs = {"a.fast5": np.arange(10, dtype=np.int16),
            "sub/a.fast5": np.arange(20, dtype=np.int16)}
    work = tmp_path / "work"
    os.makedirs(work / "sub")
    rids = {}
    for arc, sig in sigs.items():
        rid = f"rid-{arc.replace('/', '-')}"
        make_single_f5(work / arc, rid, sig)
        rids[arc] = rid
    tar = tmp_path / "batch.tar"
    with tarfile.open(tar, "w") as tf:
        for arc in sigs:
            tf.add(work / arc, arcname=arc)
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("".join(f"batch.tar/{arc}\t{rid}\n" for arc, rid in rids.items()))
    idx = fast5.Fast5Index(str(fofn))
    out = tmp_path / "out"
    # request only the shallow member whose path is a suffix of the deep one
    idx.materialize_reads([rids["a.fast5"]], str(out))
    assert sorted(os.listdir(out)) == ["a.fast5"]
    np.testing.assert_array_equal(fast5._read_signal(str(out / "a.fast5")),
                                  sigs["a.fast5"])


def make_ont_bulk_f5(path, reads):
    """Build a bulk fast5 exactly as ont_fast5_api's converter lays it out."""
    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = "2.0"
        for rid, (sig, read_number) in reads.items():
            g = f.create_group(f"read_{rid}")
            g.attrs["run_id"] = np.bytes_(b"run0001")
            raw = g.create_group("Raw")
            raw.attrs["read_id"] = np.bytes_(rid.encode())
            raw.attrs["read_number"] = np.uint32(read_number)
            raw.attrs["duration"] = np.uint32(len(sig))
            raw.create_dataset("Signal", data=sig.astype(np.int16))
            for name in ("channel_id", "context_tags", "tracking_id"):
                sub = g.create_group(name)
            g["channel_id"].attrs["sampling_rate"] = np.float64(4000.0)
            g["tracking_id"].attrs["run_id"] = np.bytes_(b"run0001")


def test_ont_shaped_bulk_reads_and_converts(tmp_path):
    """A bulk file in ont_fast5_api's exact layout indexes, reads back, and
    converts to canonical single-read files."""
    rng = np.random.default_rng(5)
    reads = {f"ont-read-{i:04d}": (rng.integers(300, 900, 80 + i).astype(np.int16), 100 + i)
             for i in range(3)}
    bulk = tmp_path / "ontbatch.fast5"
    make_ont_bulk_f5(bulk, reads)
    assert fast5.is_multi_read(str(bulk))
    lines = list(fast5.index(str(tmp_path)))
    assert len(lines) == 3
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    for rid, (sig, _) in reads.items():
        np.testing.assert_array_equal(idx.get_raw(rid), sig)
    # bulk -> single: canonical layout (Raw/Reads/Read_<n> + UniqueGlobalKey)
    out = tmp_path / "singles"
    idx.extract(str(bulk), str(out), format="single")
    for rid, (sig, read_number) in reads.items():
        single = out / f"{rid}.fast5"
        assert fast5.read_id_single(str(single)) == rid
        with h5py.File(single) as f:
            g = f[f"Raw/Reads/Read_{read_number}"]
            np.testing.assert_array_equal(g["Signal"][()], sig)
            assert g.attrs["read_number"] == read_number
            assert f["UniqueGlobalKey/channel_id"].attrs["sampling_rate"] == 4000.0
            assert f["UniqueGlobalKey/tracking_id"].attrs["run_id"] == b"run0001"


def test_singles_to_multi_ont_layout(tmp_path, real_read):
    """single -> multi emits ont_fast5_api's layout; real reference read
    round-trips both directions."""
    bulk = tmp_path / "packed.fast5"
    fast5.singles_to_multi([DATA_F5], str(bulk))
    with h5py.File(bulk) as f:
        assert f.attrs["file_version"] == "2.0"
        g = f[f"read_{GOLD_ID}"]
        assert g.attrs["run_id"] == h5py.File(DATA_F5)["UniqueGlobalKey/tracking_id"].attrs["run_id"]
        # ont shape: Signal directly under Raw, read attrs on Raw
        assert isinstance(g["Raw/Signal"], h5py.Dataset)
        assert g["Raw"].attrs["read_id"] == GOLD_ID.encode()
        assert g["Raw"].attrs["read_number"] == 2628
        for name in ("channel_id", "context_tags", "tracking_id"):
            assert name in g
        assert g["channel_id"].attrs["digitisation"] == 8192.0
    # read back through the index machinery
    lines = list(fast5.index(str(bulk)))
    fofn = tmp_path / "reads.fofn"
    fofn.write_text("\n".join(lines) + "\n")
    idx = fast5.Fast5Index(str(fofn))
    with h5py.File(DATA_F5) as f:
        orig = f["Raw/Reads/Read_2628/Signal"][()]
    np.testing.assert_array_equal(idx.get_raw(GOLD_ID), orig)
    # multi -> single again: canonical single, identical signal
    out = tmp_path / "unpacked"
    idx.extract(str(bulk), str(out), format="single")
    single = out / f"{GOLD_ID}.fast5"
    assert fast5.read_id_single(str(single)) == GOLD_ID
    with h5py.File(single) as f:
        np.testing.assert_array_equal(f["Raw/Reads/Read_2628/Signal"][()], orig)
        assert f["UniqueGlobalKey/channel_id"].attrs["offset"] == 49.0


def test_conversion_preserves_non_raw_content(tmp_path):
    """Basecall data (Analyses subtree, datasets inside UniqueGlobalKey
    groups) must survive single -> multi -> single, not just Raw/attrs
    (the reference converts through ont_fast5_api, which is lossless,
    STRique_lib/fast5Index.py:96-135)."""
    rid = "read-with-analyses"
    src = tmp_path / f"{rid}.fast5"
    sig = np.arange(64, dtype=np.int16)
    make_single_f5(src, rid, sig)
    with h5py.File(src, "r+") as f:
        bc = f.create_group("Analyses/Basecall_1D_000/BaseCalled_template")
        bc.create_dataset("Fastq", data=np.bytes_(b"@r\nACGT\n+\n!!!!\n"))
        f["Analyses/Basecall_1D_000"].attrs["name"] = np.bytes_(b"caller")
        ugk = f.create_group("UniqueGlobalKey/tracking_id")
        ugk.attrs["run_id"] = np.bytes_(b"runX")
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.create_dataset("calibration", data=np.array([1.0, 2.0]))

    bulk = tmp_path / "packed.fast5"
    fast5.singles_to_multi([str(src)], str(bulk))
    with h5py.File(bulk) as f:
        g = f[f"read_{rid}"]
        assert g["Analyses/Basecall_1D_000"].attrs["name"] == b"caller"
        assert g["Analyses/Basecall_1D_000/BaseCalled_template/Fastq"][()] \
            == b"@r\nACGT\n+\n!!!!\n"
        np.testing.assert_array_equal(g["channel_id/calibration"][()], [1.0, 2.0])
        assert g.attrs["run_id"] == b"runX"

    out = tmp_path / "single_out.fast5"
    with h5py.File(bulk) as f:
        fast5.multi_group_to_single(f, f"read_{rid}", str(out))
    with h5py.File(out) as f:
        assert f["Analyses/Basecall_1D_000/BaseCalled_template/Fastq"][()] \
            == b"@r\nACGT\n+\n!!!!\n"
        np.testing.assert_array_equal(
            f["UniqueGlobalKey/channel_id/calibration"][()], [1.0, 2.0])
        np.testing.assert_array_equal(
            f[f"Raw/Reads/Read_0/Signal"][()], sig)


def test_multi_to_single_ugk_named_child(tmp_path):
    """A bulk read group carrying a child literally named UniqueGlobalKey
    must merge into the created UniqueGlobalKey group instead of
    colliding with it (h5py raises on duplicate names, aborting the
    conversion)."""
    rid = "read-ugk-child"
    src = tmp_path / f"{rid}.fast5"
    sig = np.arange(32, dtype=np.int16)
    make_single_f5(src, rid, sig)
    bulk = tmp_path / "packed.fast5"
    fast5.singles_to_multi([str(src)], str(bulk))
    with h5py.File(bulk, "r+") as f:
        extra = f.create_group(f"read_{rid}/UniqueGlobalKey/context_args")
        extra.attrs["note"] = np.bytes_(b"kept")
    out = tmp_path / "single_out.fast5"
    with h5py.File(bulk) as f:
        fast5.multi_group_to_single(f, f"read_{rid}", str(out))
    with h5py.File(out) as f:
        assert f["UniqueGlobalKey/context_args"].attrs["note"] == b"kept"
        np.testing.assert_array_equal(f["Raw/Reads/Read_0/Signal"][()], sig)
