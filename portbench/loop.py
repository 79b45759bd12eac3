"""The one traffic generator: set-up, warm-up and the measured window of a
cell, driven by its traffic file (``portbench/traffic/<name>.json``).

A traffic file holds parameters only:

* ``entry``: ``describe`` (each client calls ``tpuprof_torch.describe``
  back to back) or ``scheduler`` (each client submits a job to one
  in-process ``ProfileScheduler`` and waits for its terminal state before
  it submits the next);
* ``clients``, ``tenants``, ``workers`` (the scheduler's);
* ``source``: ``config`` (the table in the form its configuration states:
  a DataFrame, or one Parquet file) or ``files`` (``files`` Parquet files
  of ``rows_per_file`` rows each, file k made from the seed and k; client
  i cycles over the files whose index is i modulo ``clients``);
* ``profile_passes``: ``two_pass`` or ``fused``; ``seed_edges``: the
  fused profile reads an artifact of a two-pass profile of the same table
  written at set-up;
* ``warm_rows``: the rows of the warm-up profile;
* ``launches_per_batch``: each kernel's launches a batch (the launch
  counters of the kernels' wrappers, read before and after);
  ``phases_absent``: spans a profile must not have; ``singlepass``: the
  single-pass counters a profile must leave, per lane (``edge_hits``) or
  in all (``edge_misses``, ``rebins``).
"""

from __future__ import annotations

import importlib
import os
import threading
import time
from typing import Dict, List

from portbench import compare, data, hoststat

# kernel -> (its wrapper's module in tpuprof_torch.kernels, launch count)
COUNTERS = {"fused_a": ("fused", "launches"), "hist_b": ("hist", "launches"),
            "fused_wide": ("fused", "launches_wide"),
            "spear": ("fused", "launches_spear"),
            "rank": ("fused", "launches_rank"),
            "fused_ab": ("fused", "launches_ab")}
SINGLEPASS = ("edge_hits", "edge_misses", "rebins")


def read_counts() -> Dict[str, int]:
    """{kernel: launches} and the single-pass counters, as they stand."""
    out = {}
    for k, (mod, attr) in COUNTERS.items():
        out[k] = getattr(importlib.import_module(
            f"tpuprof_torch.kernels.{mod}"), attr)
    sp = importlib.import_module("tpuprof_torch.runtime.singlepass")
    for k in SINGLEPASS:
        out[k] = getattr(sp, k)
    return out


def diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def numeric_lanes(config: Dict) -> int:
    """The columns that the engine reads as numeric lanes."""
    n = 0
    for spec in config["columns"]:
        if spec["dtype"] in ("int64", "float32", "float64"):
            n += int(spec.get("count", 1))
    return n


class Cell:
    """One run of one cell: ``setup``, ``window``, then ``answers``."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 workdir: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.batch_rows = int(config["batch_rows"])
        self.kwargs = {"bins": int(config["bins"]),
                       "corr_reject": float(config["corr_reject"]),
                       "batch_rows": self.batch_rows,
                       "profile_passes": traffic["profile_passes"]}
        self.profiles: List[Dict] = []      # one a completed profile or job
        self.failed: List[str] = []
        self.work_missing: List[str] = []
        self.scheduler = None
        self.rss_marks: List = []           # (after what, VmRSS bytes)

    # -- set-up ------------------------------------------------------------

    def _table(self, k=None):
        if k is None:
            return data.make_table(self.config, int(self.config["rows"]),
                                   self.seed)
        return data.make_table(self.config,
                               int(self.traffic["rows_per_file"]),
                               [self.seed, k + 1])

    def setup(self) -> None:
        import tpuprof_torch
        t = self.traffic
        warm = int(t["warm_rows"])
        self.rss_marks.append(("imports", hoststat.rss()))
        if t["source"] == "files":
            self.sources = []
            for k in range(int(t["files"])):
                path = os.path.join(self.workdir, f"table-{k}.parquet")
                self.sources.append(data.write_parquet(self._table(k), path))
        else:
            df = self._table()
            self.rss_marks.append(("table", hoststat.rss()))
            if self.config["form"] == "parquet":
                self.sources = [data.write_parquet(
                    df, os.path.join(self.workdir, "table.parquet"))]
                head = data.write_parquet(
                    df.iloc[:warm], os.path.join(self.workdir,
                                                 "warm.parquet"))
                del df
            else:
                self.sources = [df]
                head = df.iloc[:warm]
        # each source's batches, as the engine reads them: a frame in
        # windows of batch_rows, a Parquet file in windows that also end
        # at its row groups' edges
        self.batches = [data.batch_sizes(s, self.batch_rows)
                        for s in self.sources]
        self.rows = [sum(b) for b in self.batches]
        self.rss_marks.append(("sources", hoststat.rss()))
        if t.get("seed_edges"):
            # the artifact a repeat profile reads: a two-pass profile of
            # the same table, exported
            from tpuprof_torch.artifact import write_artifact
            kw = dict(self.kwargs, profile_passes="two_pass")
            stats = tpuprof_torch.describe(self.sources[0],
                                           device=self.device, **kw)
            path = os.path.join(self.workdir, "seed.json")
            write_artifact(path, stats=stats)
            del stats
            self.kwargs["seed_edges"] = path
        if t["entry"] == "scheduler":
            from tpuprof_torch.serve.scheduler import ProfileScheduler
            self.scheduler = ProfileScheduler(workers=int(t["workers"]),
                                              device=self.device)
            # a round of as many jobs as there are workers: each worker's
            # runner is built before the window
            jobs = [self.scheduler.submit(
                source=self.sources[i % len(self.sources)],
                tenant=f"t{i % int(t['tenants'])}",
                artifact=os.path.join(self.workdir, f"warm-{i}.json"),
                config_kwargs=dict(self.kwargs))
                for i in range(int(t["workers"]))]
            for job in jobs:
                self.scheduler.wait(job, timeout=600)
                if job.state != "done":
                    raise RuntimeError(f"warm-up job {job.state}: "
                                       f"{job.error}")
        else:
            tpuprof_torch.describe(head, device=self.device, **self.kwargs)
        self.rss_marks.append(("warm-up", hoststat.rss()))

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, requests=None) -> float:
        """Run the traffic until ``seconds`` have passed (or each client
        has sent ``requests``); every request started by then is waited
        for.  Returns the last completion's ``time.perf_counter()``."""
        self.requests = requests
        t = self.traffic
        before = read_counts()
        hoststat.start()
        self.host0 = hoststat.snapshot()
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        clients = int(t["clients"])
        body = self._describe_client if t["entry"] == "describe" \
            else self._job_client
        if clients == 1:
            body(0, end)
        else:
            threads = [threading.Thread(target=body, args=(i, end),
                                        name=f"portbench-client-{i}")
                       for i in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        self.window_counts = diff(read_counts(), before)
        self.host = hoststat.delta(hoststat.snapshot(), self.host0)
        if t["entry"] == "scheduler":
            self._check_launches(self.window_counts, [
                self.batches[p["source"]] for p in self.profiles])
        done = [p["t1"] for p in self.profiles]
        return max(done) if done else time.perf_counter()

    def _more(self, sent: int) -> bool:
        return self.requests is None or sent < self.requests

    def _check_launches(self, got: Dict[str, int],
                        sources: List[List[int]]) -> None:
        """Fail the profiles of ``sources`` (each a list of its batches'
        rows) whose counters say their work was not done."""
        t = self.traffic
        batches = sum(len(b) for b in sources)
        for k, per in (t.get("launches_per_batch") or {}).items():
            if got[k] != per * batches:
                self.work_missing.append(
                    f"{k}: {got[k]} launches for {batches} batches")
        sp = t.get("singlepass") or {}
        if "edge_hits" in sp:
            want = (sp["edge_hits"] * numeric_lanes(self.config)
                    * len(sources))
            if got["edge_hits"] != want:
                self.work_missing.append(
                    f"edge_hits: {got['edge_hits']} of {want}")
        for k in ("edge_misses", "rebins"):
            if k in sp and got[k] != sp[k] * len(sources):
                self.work_missing.append(f"{k}: {got[k]}")

    def _describe_client(self, i: int, end: float) -> None:
        import tpuprof_torch
        source, rows = self.sources[0], self.rows[0]
        sent = 0
        while time.perf_counter() < end and self._more(sent):
            sent += 1
            before = read_counts()
            host0 = hoststat.snapshot()
            t0 = time.perf_counter()
            try:
                stats = tpuprof_torch.describe(source, device=self.device,
                                               **self.kwargs)
            except Exception as exc:        # noqa: BLE001 — counted
                self.failed.append(f"{type(exc).__name__}: {exc}")
                continue
            t1 = time.perf_counter()
            host = hoststat.delta(hoststat.snapshot(), host0)
            got = diff(read_counts(), before)
            self._check_launches(got, [self.batches[0]])
            phases = dict(stats.get("_phases") or {})
            for name in self.traffic.get("phases_absent") or ():
                if name in phases:
                    self.work_missing.append(f"a {name} span")
            self.profiles.append({"client": i, "t0": t0, "t1": t1,
                                  "rows": rows, "phases": phases,
                                  "host": host,
                                  "answer": compare.program_view(stats),
                                  "source": 0})
            del stats

    def _job_client(self, i: int, end: float) -> None:
        t = self.traffic
        mine = [k for k in range(len(self.sources))
                if k % int(t["clients"]) == i]
        n = 0
        while time.perf_counter() < end and self._more(n):
            k = mine[n % len(mine)]
            path = os.path.join(self.workdir, f"job-{i}-{n}.json")
            n += 1
            t0 = time.perf_counter()
            job = self.scheduler.submit(
                source=self.sources[k], tenant=f"t{i % int(t['tenants'])}",
                artifact=path, config_kwargs=dict(self.kwargs))
            try:
                job = self.scheduler.wait(job, timeout=600)
            except TimeoutError as exc:
                self.failed.append(str(exc))
                continue
            t1 = time.perf_counter()
            if job.state != "done":
                self.failed.append(f"job {job.state}: {job.error}")
                continue
            self.profiles.append({
                "client": i, "t0": t0, "t1": t1, "rows": self.rows[k],
                "queue_wait": job.started_at - job.enqueued_at,
                "artifact": path, "source": k})

    def close(self) -> None:
        if self.scheduler is not None:
            self.scheduler.shutdown(wait=True)
            self.scheduler = None

    # -- the answers -------------------------------------------------------

    def answers(self):
        """(source index, the answer in the reference's form) of every
        profile or job completed."""
        import json
        for p in self.profiles:
            if "answer" in p:
                yield p["source"], p.pop("answer")
            else:
                with open(p["artifact"]) as fh:
                    yield p["source"], compare.program_view(json.load(fh))

    def tables(self):
        """The tables the sources were made from, made again."""
        if self.traffic["source"] == "files":
            return [self._table(k) for k in range(len(self.sources))]
        if self.config["form"] == "parquet":
            return [self._table()]
        return [self.sources[0]]

