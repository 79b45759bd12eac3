"""The port's elastic fleet primitives (``tpuprof_torch/runtime/fleet.py``).

The reference's ``TestPrimitives`` (``tests/test_fleet_runtime.py``) run
against the port's ``FleetMember``: exclusive and exhaustive claims, adoption
of a restarted member's claims (stolen ones excluded), steal arbitration
with one winner, the finish barrier stealing a dead member's fragments and
waiting on a live one, the part and manifest corruption sweeps raising
``CorruptManifestError`` at every cut, in-flight temporaries skipped,
claims published with their content, a restarted member's part superseding
its predecessor's, fencing, overlapping parts refused, parsed parts cached.
Then what the port adds: a fleet directory the reference started is refused
with ``CorruptManifestError``, a reference-written part is refused, and the
part and manifest envelopes are the reference's bytes but for the schema
name.
"""

import os

import numpy as np
import pytest

from tpuprof.runtime import fleet as ref_fleetrt
from tpuprof_torch.errors import (CorruptManifestError, HostDeathError,
                                  InputError, exit_code)
from tpuprof_torch.obs import metrics as obs_metrics
from tpuprof_torch.runtime import fleet as fleetrt
from tpuprof_torch.testing import faults


@pytest.fixture(autouse=True)
def _isolation():
    faults.reset()
    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)       # counters record for asserts
    obs_metrics.registry().reset()
    yield
    obs_metrics.registry().reset()
    obs_metrics.set_enabled(was)
    faults.reset()


def _member(tmp_path, host, n=4, fp="src", **kw):
    kw.setdefault("liveness_timeout_s", 30.0)
    return fleetrt.FleetMember(str(tmp_path / "fleet"), host, n, fp, **kw)


class TestPrimitives:

    def test_claims_are_exclusive_and_exhaustive(self, tmp_path):
        a = _member(tmp_path, "a", n=5)
        b = _member(tmp_path, "b", n=5)
        got_a = set()
        got_b = set()
        while True:
            k = a.claim_next("a")
            if k is None:
                break
            got_a.add(k)
            k = b.claim_next("a")
            if k is not None:
                got_b.add(k)
        assert not (got_a & got_b)
        assert got_a | got_b == set(range(5))
        a.close(), b.close()

    def test_manifest_mismatch_is_input_error(self, tmp_path):
        a = _member(tmp_path, "a", n=4, fp="src1")
        with pytest.raises(InputError):
            _member(tmp_path, "b", n=4, fp="src2")
        with pytest.raises(InputError):
            _member(tmp_path, "c", n=5, fp="src1")
        a.close()

    def test_adoption_restores_claims_and_done(self, tmp_path):
        a = _member(tmp_path, "a", n=4)
        assert a.claim_next("a") == 0
        assert a.claim_next("a") == 1
        a.mark_done("a", 0)
        a.depart()                      # simulated death
        heir = _member(tmp_path, "a", n=4)
        assert heir.claimed("a") == {0, 1}
        assert heir.done("a") == {0}
        heir.undo_done("a", [0])
        assert heir.done("a") == set()
        heir.close()

    def test_steal_arbitration_single_winner(self, tmp_path):
        dead = _member(tmp_path, "dead", n=3)
        assert dead.claim_next("a") == 0
        dead.depart()
        s1 = _member(tmp_path, "s1", n=3)
        s2 = _member(tmp_path, "s2", n=3)
        # both survivors observe the same dead owner + generation and
        # race the O_EXCL create: exactly one wins
        _, g1 = s1._owner_gen("a", 0)
        _, g2 = s2._owner_gen("a", 0)
        assert g1 == g2 == 1
        assert {s1._steal("a", 0, g1), s2._steal("a", 0, g2)} \
            == {True, False}
        # the thief is now the owner; a stale decision cannot re-rob a
        # live thief (the generation moved on)
        live = s1.live_hosts()
        owner = s1._owner("a", 0)
        assert owner in ("s1", "s2") and not s1.is_dead(owner, live)
        s1.close(), s2.close()

    def test_finish_steals_dead_hosts_fragments(self, tmp_path):
        dead = _member(tmp_path, "dead", n=3)
        assert dead.claim_next("x") == 0
        assert dead.claim_next("x") == 1
        dead.depart()                   # contributed nothing

        survivor = _member(tmp_path, "s", n=3)
        assert survivor.claim_next("x") == 2
        scanned = []

        def steal_scan(frags):
            scanned.append(list(frags))
            return {"v": 2}

        parts = survivor.finish("x", {"v": 1}, [2], steal_scan,
                                timeout_s=30)
        assert scanned == [[0, 1]]
        # deterministic merge order: (host, seq) — the survivor's own
        # contribution (seq 0) precedes its steal part (seq 1)
        assert [p["fragments"] for p in parts] == [[2], [0, 1]]
        reg = obs_metrics.registry()
        assert reg.counter(
            "tpuprof_fleet_rebalances_total").total() == 1
        assert reg.counter(
            "tpuprof_fragments_stolen_total").total() == 2
        survivor.close()

    def test_finish_waits_for_live_peer(self, tmp_path):
        """A LIVE peer's unfinished fragment is waited on, not stolen —
        the watchdog deadline converts a genuinely wedged fleet into a
        typed failure instead of a wrong steal."""
        from tpuprof_torch.errors import WatchdogTimeout
        slow = _member(tmp_path, "slow", n=2)
        assert slow.claim_next("x") == 0
        fast = _member(tmp_path, "fast", n=2)
        assert fast.claim_next("x") == 1
        with pytest.raises(WatchdogTimeout):
            fast.finish("x", {}, [1], lambda f: {}, timeout_s=0.6)
        assert fleetrt._STOLEN.total() == 0
        slow.close(), fast.close()

    def test_part_roundtrip_and_corruption_sweep(self):
        payload = {"rows": 123, "arr": np.arange(4)}
        raw = fleetrt.write_part_bytes(payload)
        back = fleetrt.read_part_bytes(raw)
        assert back["rows"] == 123
        # torn at EVERY byte offset: always the typed error, never a
        # raw EOFError/UnpicklingError (the PR-4 sweep, for parts)
        for cut in range(len(raw)):
            with pytest.raises(CorruptManifestError):
                fleetrt.read_part_bytes(raw[:cut])
        # bit flips in the payload region trip the CRC
        flipped = bytearray(raw)
        flipped[-1] ^= 0xFF
        with pytest.raises(CorruptManifestError):
            fleetrt.read_part_bytes(bytes(flipped))

    def test_manifest_bytes_corruption_sweep(self):
        doc = {"n_fragments": 7, "fingerprint": "abc"}
        raw = fleetrt.write_manifest_bytes(doc)
        assert fleetrt.read_manifest_bytes(raw) == doc
        for cut in range(len(raw) - 1):
            with pytest.raises(CorruptManifestError):
                fleetrt.read_manifest_bytes(raw[:cut])
        with pytest.raises(CorruptManifestError):
            fleetrt.read_manifest_bytes(raw.replace(b"abc", b"abd"))

    def test_torn_manifest_file_is_typed(self, tmp_path):
        a = _member(tmp_path, "a", n=4)
        a.close()
        path = tmp_path / "fleet" / "manifest.json"
        path.write_bytes(path.read_bytes()[:20])
        with pytest.raises(CorruptManifestError):
            _member(tmp_path, "b", n=4)

    def test_read_parts_skips_in_flight_tmp_files(self, tmp_path):
        """A reader racing another member's atomic part write must see
        either nothing or the complete file — never the in-flight tmp
        bytes.  Regression: the tmp used to be named
        ``part.<phase>.<host>.<seq>.tmp.<pid>``, which still matched
        the ``part.<phase>.`` prefix scan, so a concurrent finish
        barrier read torn bytes and died with CorruptManifestError."""
        a = _member(tmp_path, "a", n=2)
        a.contribute("a", {"rows": 5}, [0])
        fleet = tmp_path / "fleet"
        # an in-flight write: both the current dot-prefixed tmp naming
        # and the old colliding one must be ignored by the scans
        (fleet / ".tmp.part.a.b.0.77").write_bytes(b"torn")
        (fleet / "part.a.b.0.tmp.77").write_bytes(b"torn")
        (fleet / ".tmp.wire.b.77").write_bytes(b"torn")
        parts = a.read_parts("a")
        assert [p["host"] for p in parts] == ["a"]
        assert a.coverage("a") == {0}
        # a COMPLETED torn part still raises — only tmps are skipped
        (fleet / "part.a.b.0").write_bytes(b"torn")
        with pytest.raises(CorruptManifestError):
            a.read_parts("a")
        a.close()

    def test_claim_files_publish_atomically_with_content(self, tmp_path):
        """Claims are hardlink-published: the file appears WITH its
        owner already written (an O_EXCL create + write left a window
        where a racing reader saw an empty claim, judged the owner ''
        dead, and stole a live host's fresh claim).  No tmp debris
        survives either path of the race."""
        a = _member(tmp_path, "a", n=2)
        assert a.claim_next("x") == 0
        fleet = tmp_path / "fleet"
        assert (fleet / "claim.x.0").read_text() == "a"
        assert not [n for n in os.listdir(fleet)
                    if n.startswith(".tmp.")]
        # losing the race leaves no debris and no clobbered content
        assert fleetrt._excl_create(str(fleet / "claim.x.0"), "b") \
            is False
        assert (fleet / "claim.x.0").read_text() == "a"
        assert not [n for n in os.listdir(fleet)
                    if n.startswith(".tmp.")]
        a.close()

    def test_restarted_member_supersedes_predecessor_part(self, tmp_path):
        """A member that died AFTER contributing and restarts with the
        same host id re-covers its claims; the predecessor's part must
        be superseded, not merged alongside — two parts covering the
        same fragments double-count every row (REVIEW: high)."""
        a = _member(tmp_path, "a", n=2)
        assert a.claim_next("x") == 0
        assert a.claim_next("x") == 1
        parts = a.finish("x", {"v": 1}, [0, 1], lambda f: {"v": 9},
                         timeout_s=30)
        assert [p["fragments"] for p in parts] == [[0, 1]]
        a.depart()
        heir = _member(tmp_path, "a", n=2)
        assert heir.claimed("x") == {0, 1}
        parts = heir.finish("x", {"v": 2}, sorted(heir.claimed("x")),
                            lambda f: {"v": 9}, timeout_s=30)
        # exactly one part covers the fragments, and it is the heir's
        assert [p["fragments"] for p in parts] == [[0, 1]]
        assert [p["v"] for p in parts] == [2]
        # seq stayed monotone across the supersede: a peer's part
        # cache can never alias the old bytes onto a reused filename
        assert all(p["seq"] > 0 for p in parts)
        heir.close()

    def test_fencing_discards_tainted_part_and_rescans(self, tmp_path):
        """A live member whose heartbeat merely LOOKED stale gets a
        fragment stolen; when it later contributes, the stolen
        fragment's rows are inside its monolithic fold — the part is
        fenced and the surviving fragments re-scan from scratch
        instead of double-counting (REVIEW: high)."""
        victim = _member(tmp_path, "v", n=2)
        assert victim.claim_next("x") == 0
        assert victim.claim_next("x") == 1
        thief = _member(tmp_path, "t", n=2)
        assert thief._steal("x", 0, 1)      # victim judged dead wrongly
        thief.contribute("x", {"v": "thief"}, [0])
        rescans = []

        def rescan(frags):
            rescans.append(list(frags))
            return {"v": "rescanned"}

        parts = victim.finish("x", {"v": "tainted"}, [0, 1], rescan,
                              timeout_s=30)
        assert rescans == [[1]]             # only the surviving fragment
        assert victim.claimed("x") == {1}   # ownership view fenced too
        assert sorted(p["v"] for p in parts) == ["rescanned", "thief"]
        covered = sorted(k for p in parts for k in p["fragments"])
        assert covered == [0, 1]            # disjoint, complete
        victim.close(), thief.close()

    def test_adoption_skips_stolen_fragments(self, tmp_path):
        """A restarted member must NOT adopt claims a survivor stole
        while it was down: the thief's part covers them already."""
        a = _member(tmp_path, "a", n=3)
        assert a.claim_next("x") == 0
        assert a.claim_next("x") == 1
        a.mark_done("x", 0)
        a.depart()
        thief = _member(tmp_path, "t", n=3)
        assert thief._steal("x", 0, 1)
        heir = _member(tmp_path, "a", n=3)
        assert heir.claimed("x") == {1}     # 0 belongs to the thief now
        assert heir.done("x") == set()
        thief.close(), heir.close()

    def test_overlapping_parts_are_a_typed_error(self, tmp_path):
        """Backstop for every steal/fence/supersede race: if two parts
        ever cover the same fragment, finish() must raise the typed
        error instead of silently merging double-counted rows."""
        a = _member(tmp_path, "a", n=1)
        b = _member(tmp_path, "b", n=1)
        a.contribute("x", {"v": 1}, [0])
        b.contribute("x", {"v": 2}, [0])
        with pytest.raises(CorruptManifestError, match="covered by both"):
            a.finish("x", {}, [], lambda f: {}, timeout_s=5)
        a.close(), b.close()

    def test_finish_polls_reuse_cached_parts(self, tmp_path,
                                             monkeypatch):
        """Published parts are immutable and never renamed — each file
        pays its read + CRC + unpickle exactly once however often the
        finish barrier polls coverage (REVIEW: O(parts x size) I/O per
        tick hammered shared storage)."""
        a = _member(tmp_path, "a", n=1)
        a.contribute("x", {"v": 1}, [0])
        calls = []
        real = fleetrt.read_part_bytes

        def counting(raw, origin="part"):
            calls.append(origin)
            return real(raw, origin=origin)

        monkeypatch.setattr(fleetrt, "read_part_bytes", counting)
        a.read_parts("x")
        a.read_parts("x")
        assert a.coverage("x") == {0}
        assert len(calls) == 1
        a.close()


class TestAgainstTheReference:

    def test_a_fleet_dir_the_reference_started_is_refused(self, tmp_path):
        ref = ref_fleetrt.FleetMember(str(tmp_path / "fleet"), "r", 4, "src",
                                      liveness_timeout_s=30.0)
        with pytest.raises(CorruptManifestError, match="schema"):
            _member(tmp_path, "p", n=4, fp="src")
        ref.close()

    def test_the_port_manifest_is_refused_by_the_reference(self, tmp_path):
        mine = _member(tmp_path, "p")
        from tpuprof.errors import CorruptManifestError as RefCorrupt
        with pytest.raises(RefCorrupt):
            ref_fleetrt.FleetMember(str(tmp_path / "fleet"), "r", 4, "src",
                                    liveness_timeout_s=30.0)
        mine.close()

    def test_a_part_naming_reference_classes_is_refused(self, tmp_path):
        from tpuprof.ingest.sample import RowSampler as RefSampler
        raw = ref_fleetrt.write_part_bytes({"sampler": RefSampler(4, 1)})
        with pytest.raises(CorruptManifestError, match="unreadable"):
            fleetrt.read_part_bytes(raw)

    def test_envelopes_are_the_references_but_for_the_schema(self):
        payload = {"rows": 7, "fragments": [0, 2], "x": np.arange(3)}
        assert fleetrt.write_part_bytes(payload) == \
            ref_fleetrt.write_part_bytes(payload)
        doc = {"n_fragments": 3, "fingerprint": "f"}
        mine = fleetrt.write_manifest_bytes(doc)
        theirs = ref_fleetrt.write_manifest_bytes(doc)
        assert mine.split(b"\n")[1:] == theirs.split(b"\n")[1:]
        assert fleetrt.MANIFEST_SCHEMA.encode() in mine.split(b"\n")[0]
        assert ref_fleetrt.MANIFEST_SCHEMA.encode() not in mine

    def test_exit_codes_for_the_fleet_errors(self):
        from tpuprof.errors import exit_code as ref_exit_code
        assert exit_code(CorruptManifestError("x")) == 7 == \
            ref_exit_code(ref_fleetrt.CorruptManifestError("x"))
        assert exit_code(HostDeathError("host_death", 1)) == 8
        assert isinstance(CorruptManifestError("x"), ValueError)
        assert isinstance(HostDeathError("s", 1), RuntimeError)
        assert not isinstance(InputError("x"), CorruptManifestError)

    @pytest.mark.parametrize("k", [1, 3])
    def test_host_death_fires_where_the_reference_does(self, k):
        from tpuprof.errors import HostDeathError as RefDeath
        from tpuprof.testing import faults as ref_faults
        died = []
        for mod, err in ((faults, HostDeathError), (ref_faults, RefDeath)):
            mod.configure(f"host_death:@{k}", seed=0)
            try:
                for key in range(5):
                    try:
                        mod.hit("host_death", key=key)
                    except err as exc:
                        died.append((key, exc.at_call))
                        mod.hit("host_death", key=key)   # a retry passes
                assert mod.injected("host_death") == 1
            finally:
                mod.reset()
        assert died == [(k - 1, k)] * 2
