"""The port's durable intake journal (``serving/journal.py``) against the
reference's, in lockstep: the same accept/mark/term sequences on the same
wall clock write byte-identical segments and compact files; each
package's ``scan_dir`` recovers the other's directory; the torn-tail
sweep holds at every byte boundary of the final record; and a journal
reopened over either package's directory recovers the same state.  Host
logic only: equality is exact."""

import json
import os
import subprocess
import sys

import pytest

from cst_captioning_tpu.serving import journal as ref_journal
from cst_captioning_tpu_torch.serving import journal as port_journal
from cst_captioning_tpu_torch.utils import locksan

IMPLS = {"reference": ref_journal, "port": port_journal}


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch, tmp_path):
    """The port's journal lock is made under the armed sanitizer."""
    receipt = tmp_path / "locksan_violation.json"
    monkeypatch.setenv(locksan.ENV_FLAG, "1")
    monkeypatch.setenv(locksan.ENV_RECEIPT, str(receipt))
    before = len(locksan.violations())
    yield
    assert locksan.violations()[before:] == []
    assert not receipt.exists()


class Wall:
    """A deterministic wall clock: 500.0, 501.0, ..."""

    def __init__(self):
        self.t = 499.0

    def __call__(self):
        self.t += 1.0
        return self.t


def storm(j):
    """Three requests: two answered, one stream left open with a mark."""
    j.accept("k0", "c0", "v0", stream=False, ttl_ms=None, no_cache=False)
    j.accept("k1", "c1", "v1", stream=True, ttl_ms=60000.0, no_cache=True)
    j.mark("k1", 0, [11, 12], "w11 w12", 2)
    j.terminal("k0", {"id": "c0", "video_id": "v0", "caption": "w1 w2"})
    j.accept("k2", "c2", "v2", stream=False, ttl_ms=250.5, no_cache=False)
    j.terminal("k2", {"id": "c2", "video_id": "v2", "caption": "w3"})


def rotating(j):
    """Every append seals a segment: rotation (and compaction) each time;
    a duplicate terminal and a retired key on the way."""
    for i in range(6):
        j.accept(f"k{i}", f"c{i}", f"v{i}", stream=bool(i % 2),
                 ttl_ms=None if i % 3 else 1000.0 * i, no_cache=False)
        if i % 2:
            j.mark(f"k{i}", 0, [i, i + 1], f"w{i} w{i + 1}", 2)
        if i != 3:
            j.terminal(f"k{i}", {"id": f"c{i}", "video_id": f"v{i}",
                                 "caption": f"w{i}"})
    j.terminal("k0", {"id": "c0", "video_id": "v0", "caption": "again"})


SEQUENCES = {
    "storm": (storm, {}),
    "rotate_compact": (rotating, {"segment_bytes": 1, "compact": True}),
    "rotate_forensic": (rotating, {"segment_bytes": 1, "compact": False}),
    "rotate_400": (rotating, {"segment_bytes": 400, "compact": True}),
}


def write(impl, root, seq):
    fn, kw = SEQUENCES[seq]
    j = IMPLS[impl].IntakeJournal(str(root), wall=Wall(), **kw)
    fn(j)
    stats = j.stats()
    j.close()
    return stats


def files(root):
    return {n: open(os.path.join(root, n), "rb").read()
            for n in sorted(os.listdir(root))}


def recovery_view(rec):
    """A JournalRecovery as plain data (either package's)."""
    return {"accepts": rec.accepts, "marks": rec.marks,
            "terminals": rec.terminals,
            "terminal_order": rec.terminal_order,
            "torn_records": rec.torn_records,
            "segments_scanned": rec.segments_scanned,
            "records": rec.records,
            "open": [r["key"] for r in rec.open_requests()]}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_same_sequence_writes_byte_identical_files(tmp_path, seq):
    s_ref = write("reference", tmp_path / "ref", seq)
    s_port = write("port", tmp_path / "port", seq)
    got, want = files(tmp_path / "port"), files(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    assert got == want
    for s in (s_ref, s_port):
        s.pop("dir")
    assert s_port == s_ref


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_each_scan_dir_recovers_the_others_directory(tmp_path, seq, writer,
                                                     reader):
    root = tmp_path / "j"
    write(writer, root, seq)
    before = sorted(os.listdir(root))
    got = recovery_view(IMPLS[reader].scan_dir(str(root)))
    assert got == recovery_view(IMPLS[writer].scan_dir(str(root)))
    assert IMPLS[reader].list_segments(str(root)) == \
        IMPLS[writer].list_segments(str(root))
    assert sorted(os.listdir(root)) == before      # scan is read-only


@pytest.mark.parametrize("writer", sorted(IMPLS))
def test_reopen_over_either_directory_recovers_the_same_state(tmp_path,
                                                              writer):
    root = tmp_path / "j"
    write(writer, root, "storm")
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    for name, data in files(root).items():
        (shadow / name).write_bytes(data)
    port = port_journal.IntakeJournal(str(root), wall=Wall())
    ref = ref_journal.IntakeJournal(str(shadow), wall=Wall())
    assert recovery_view(port.recovery) == recovery_view(ref.recovery)
    assert port.open_requests() == ref.open_requests()
    assert port.terminal_for("k0") == ref.terminal_for("k0")
    assert port.marks_for("k1") == ref.marks_for("k1")
    assert port.is_open("k1") and not port.is_open("k0")
    # Each open starts a fresh segment, never after old bytes.
    assert port.high_water() == ref.high_water() == {
        "segment": "seg-00000002.wal", "offset": 0}
    port.terminal("k1", {"id": "c1", "caption": "w11 w12"})
    ref.terminal("k1", {"id": "c1", "caption": "w11 w12"})
    port.close()
    ref.close()
    assert files(root) == files(shadow)


def test_torn_tail_sweep_at_every_byte_boundary(tmp_path):
    """The port's segment truncated at every byte boundary of its final
    record: a sealed record is never dropped nor applied twice, a torn
    one is counted, the scan never raises, both packages' scans agree,
    and the reopened journal appends into a fresh segment."""
    root = tmp_path / "j"
    write("port", root, "storm")
    seg = root / "seg-00000001.wal"
    data = seg.read_bytes()
    tail = port_journal._encode({
        "kind": "term", "key": "k2",
        "resp": {"id": "c2", "video_id": "v2", "caption": "w3"},
        "schema": port_journal.JOURNAL_SCHEMA})
    assert data.endswith(tail)
    for keep in range(len(tail)):
        case = tmp_path / f"cut{keep}"
        case.mkdir()
        (case / seg.name).write_bytes(data[:len(data) - len(tail) + keep])
        rec = port_journal.scan_dir(str(case))
        assert recovery_view(rec) == recovery_view(
            ref_journal.scan_dir(str(case))), keep
        assert set(rec.accepts) == {"k0", "k1", "k2"}
        assert set(rec.terminals) == {"k0"}
        assert [m["seq"] for m in rec.marks["k1"]] == [0]
        assert rec.records == 5
        assert rec.torn_records == (0 if keep == 0 else 1)
        j = port_journal.IntakeJournal(str(case), wall=Wall())
        assert j.stats()["torn_records"] == rec.torn_records
        assert j.is_open("k2")
        j.terminal("k2", {"id": "c2", "caption": "w3"})
        j.close()
        assert (case / seg.name).stat().st_size == len(data) - len(tail) + keep
        assert set(port_journal.scan_dir(str(case)).terminals) == {"k0",
                                                                  "k2"}


def test_records_are_the_references_frames(tmp_path):
    rec = {"kind": "mark", "key": "k", "seq": 3, "tokens": [1, 2],
           "text": "w1 w2", "sent_tokens": 5, "schema": 1}
    assert port_journal._encode(rec) == ref_journal._encode(rec)
    line = port_journal._encode(rec)[:-1]
    assert port_journal._decode_line(line) == ref_journal._decode_line(line)
    bad = line.replace(b"w1", b"w9")
    assert port_journal._decode_line(bad) is None
    assert ref_journal._decode_line(bad) is None
    assert port_journal.RECORD_KINDS == ref_journal.RECORD_KINDS
    assert port_journal.TERMINAL_KEEP == ref_journal.TERMINAL_KEEP
    assert json.loads(json.loads(line)["v"]) == rec


TINY = ["--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16", "--vocab_size",
        "20", "--feat_shapes", "4x16,1x8", "--serve_demo_eos_bias", "-0.3",
        "--beam_size", "1"]


def test_cli_journal_probe_passes_the_references_reports(tmp_path):
    """The supervisor's process group SIGKILLed mid-storm and relaunched on
    its journal, through ``python -m cst_captioning_tpu_torch.serve_supervisor``
    on the CPU; the record through ``serve_report.py``, the run directory
    (the exit snapshot's journal block, the port's segments) through
    ``fleet_report.py``'s coverage cross-check, which scans them with the
    reference's ``scan_dir``."""
    root = tmp_path / "run"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    env.pop(locksan.ENV_FLAG, None)
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve_supervisor",
         *TINY, "--journal_probe", "1", "--supervise_replicas", "2",
         "--supervise_dir", str(root)],
        capture_output=True, text=True, timeout=120, cwd=repo, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.splitlines()[-1])
    jn = rec["journal"]
    assert jn["killed_mid_storm"] and jn["streams_in_flight_at_kill"] >= 1
    assert jn["exactly_once"] and jn["replay_accounted"]
    assert jn["dup_suppressed"] and jn["torn_ok"] and jn["clean_exit"]
    assert rec["supervisor"]["parity_ok"] and rec["stream"]["prefix_ok"]
    ledger = json.load(open(root / "recovery_ledger.json"))
    assert len(ledger["replayed"]) + ledger["recovered_terminals"] == 12
    rec_file = tmp_path / "record.jsonl"
    rec_file.write_text(proc.stdout)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # Both incarnations scrape into the one fleet_metrics.jsonl, and the
    # drill kills the first: the gap across the kill is the drill itself,
    # so the blackout gate is widened past it; every other gate holds.
    for args in (["serve_report.py", "--file", str(rec_file)],
                 ["fleet_report.py", "--dir", str(root),
                  "--blackout_factor", "1000"]):
        rep = subprocess.run(
            [sys.executable, os.path.join(repo, "scripts", args[0]),
             *args[1:]], capture_output=True, text=True, cwd=repo, env=env,
            timeout=120)
        assert rep.returncode == 0, (args[0], rep.stderr)
        assert "journal" in rep.stdout
