"""Copy-drift gate: the port's copies of the JAX package's NumPy, ctypes
and C++ modules stay the reference text, with the import prefix rewritten
and only the changes listed here. A change is ``(old, new)``, applying
where ``old`` occurs exactly once, or ``(old, new, n)`` where it occurs
exactly ``n`` times."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: port file (relative to both packages) → the (reference text, port text)
#: replacements the port makes after the import prefix is rewritten
ALLOWED = {
    "core/arrays.py": [],
    "core/types.py": [],
    "core/fastpath.py": [],
    "obs/metrics.py": [],
    # tracing_interceptor's lazy ``import grpc`` stays: the tick never
    # calls that server hook
    "obs/tracing.py": [
        # main-thread spans open a torch.profiler range while it records; tally() sums one thread's span ms for a block
        ("operations in spans.\n",
         "operations in spans.\n"
         "\n"
         "Spans opened on the main thread while ``torch.profiler`` records also open\n"
         "a profiler range of the same name, so the device trace's idle gaps are\n"
         "named by what the tick's thread was doing; other threads' spans stay out\n"
         "of it. A tracer can also keep a per-name tally of one thread's span\n"
         "milliseconds for a block (:meth:`Tracer.tally`), which the simulator's tick\n"
         "reads its phases from.\n"),
        ("import random\n",
         "import random\n"
         "import sys\n"),
        ('    tick phases, so per-span cost is tick overhead."""\n',
         "    tick phases, so per-span cost is tick overhead. Spans mark phases and\n"
         "    batches, never single objects: a per-object cost rides a counter on\n"
         '    the batch\'s span."""\n'),
        ("class _SpanContext:\n"
         '    """Context manager produced by Tracer.span()."""\n'
         "\n"
         '    __slots__ = ("_tracer", "_span", "_token")\n',
         "#: the thread whose spans reach the device trace (the tick's thread)\n"
         "_MAIN_THREAD = threading.main_thread().ident\n"
         "\n"
         "\n"
         "class _SpanContext:\n"
         '    """Context manager produced by Tracer.span()."""\n'
         "\n"
         '    __slots__ = ("_tracer", "_span", "_token", "_range")\n'),
        ("\n"
         "    def __enter__(self) -> Span:\n",
         "        self._range = None\n"
         "\n"
         "    def __enter__(self) -> Span:\n"
         "        # a profiler range of the span's name, opened outside the span's\n"
         "        # own clock; this module never imports torch, it only looks for it\n"
         '        prof = sys.modules.get("torch.autograd.profiler")\n'
         "        if (\n"
         "            prof is not None\n"
         '            and getattr(prof, "_is_profiler_enabled", False)\n'
         "            and threading.get_ident() == _MAIN_THREAD\n"
         "        ):\n"
         "            self._range = prof.record_function(self._span.name)\n"
         "            self._range.__enter__()\n"),
        ("        self._tracer._finish(self._span)\n",
         "        tracer = self._tracer\n"
         "        tally = tracer._tally\n"
         "        if tally is not None and threading.get_ident() == tracer._tally_thread:\n"
         "            name = self._span.name\n"
         "            tally[name] = tally.get(name, 0.0) + (\n"
         "                self._span._mono1 - self._span._mono0\n"
         "            ) * 1e3\n"
         "        tracer._finish(self._span)\n"
         "        if self._range is not None:\n"
         "            self._range.__exit__(None, None, None)\n"),
        ("        self._recent = deque(maxlen=256)  # tracez ring, sampled spans only\n"
         "        self._lock = threading.Lock()\n"
         "\n",
         "        self._recent = deque(maxlen=256)  # tracez ring, sampled spans only\n"
         "        self._lock = threading.Lock()\n"
         "        #: span name → summed ms of one thread's spans (:meth:`tally`)\n"
         "        self._tally: dict[str, float] | None = None\n"
         "        self._tally_thread: int | None = None\n"
         "\n"),
        ("                self._exporters_snapshot = tuple(self._exporters)\n",
         "                self._exporters_snapshot = tuple(self._exporters)\n"
         "\n"
         "    @contextlib.contextmanager\n"
         "    def tally(self):\n"
         '        """Tally the calling thread\'s spans for the ``with`` block: every\n'
         "        span that closes on it adds its milliseconds under its name,\n"
         "        sampled or not. Yields the tally's dict, which stays readable\n"
         '        after the block; spans closed after it add nothing."""\n'
         "        tally: dict[str, float] = {}\n"
         "        self._tally, self._tally_thread = tally, threading.get_ident()\n"
         "        try:\n"
         "            yield tally\n"
         "        finally:\n"
         "            self._tally = self._tally_thread = None\n"),
    ],
    "obs/events.py": [],
    "obs/explain.py": [],
    "bridge/freeze.py": [],
    "bridge/objects.py": [],
    "bridge/statusmap.py": [],
    "bridge/colstore.py": [],
    # the two lazy ``wire.coldec`` imports (the vnode raw-bytes mirror)
    # point at the port's future module
    "bridge/columns.py": [],
    # changes_since reads the writes after its cursor from a write log
    # (PERF.md §5): the steady tick's dirty-set probes were O(names ever
    # written), a million at the 500k shape, once per provider and tick
    "bridge/store.py": [
        ('import itertools\n',
         'import bisect\n'
         'import itertools\n'),
        ('        self._rv = 0\n',
         "        #: per-kind write log: each commit's names beside the highest rv\n"
         '        #: it assigned and the names logged up to it, covering every\n'
         '        #: write after ``_log_floor[kind]``, so ``changes_since`` reads\n'
         '        #: the few writes after a recent cursor instead of scanning every\n'
         '        #: name the kind ever wrote (a million at the 500k shape, once per\n'
         '        #: provider and tick)\n'
         '        self._log_rvs: dict[str, list[int]] = {}\n'
         '        self._log_names: dict[str, list] = {}\n'
         '        self._log_ends: dict[str, list[int]] = {}\n'
         '        self._log_floor: dict[str, int] = {}\n'
         '        self._rv = 0\n'),
        ('        tombs = self._tombstones.get(kind)\n'
         '        if tombs is not None:\n',
         '        self._log_writes(kind, (name,))\n'
         '        tombs = self._tombstones.get(kind)\n'
         '        if tombs is not None:\n'),
        ('            if parts:\n',
         '            logged = self._logged_since(kind, since_rv)\n'
         '            if logged is not None:\n'
         '                # the names written after the cursor that are still\n'
         '                # dirty there (a later delete drops a name): the scan\n'
         '                # below, restricted to the writes the log holds\n'
         '                dirty = [self._changed.get(kind, {}), *(parts or {}).values()]\n'
         '                changed = sorted(\n'
         '                    n for n in logged\n'
         '                    if any(d.get(n, 0) > since_rv for d in dirty)\n'
         '                )\n'
         '            elif parts:\n'),
        ('\n'
         '    def has_partitioned_dirty(self, kind: str) -> bool:\n',
         '\n'
         "    #: writes a kind's log holds before it is dropped, at least; beyond\n"
         "    #: twice the kind's dirty names it is dropped too (``changes_since``\n"
         '    #: then scans for a cursor older than the drop)\n'
         '    WRITE_LOG_MIN = 65_536\n'
         '\n'
         '    def _dirty_count(self, kind: str) -> int:\n'
         '        return len(self._changed.get(kind, ())) + sum(\n'
         '            len(d) for d in self._dirty_parts.get(kind, {}).values()\n'
         '        )\n'
         '\n'
         '    def _log_writes(self, kind: str, names) -> None:\n'
         '        """Log one commit\'s names; the store\'s rv is their highest."""\n'
         '        rvs = self._log_rvs.setdefault(kind, [])\n'
         '        batches = self._log_names.setdefault(kind, [])\n'
         '        ends = self._log_ends.setdefault(kind, [])\n'
         '        size = (ends[-1] if ends else 0) + len(names)\n'
         '        if size > self.WRITE_LOG_MIN and size > 2 * self._dirty_count(kind):\n'
         '            rvs.clear()\n'
         '            batches.clear()\n'
         '            ends.clear()\n'
         '            self._log_floor[kind] = self._rv\n'
         '            return\n'
         '        rvs.append(self._rv)\n'
         '        batches.append(names)\n'
         '        ends.append(size)\n'
         '\n'
         '    def _logged_since(self, kind: str, since_rv: int) -> set[str] | None:\n'
         '        """Every name written after ``since_rv`` (some written before it\n'
         '        too), or None when the log does not reach back that far or when\n'
         '        so much of the kind moved that the scan reads less."""\n'
         '        if since_rv < self._log_floor.get(kind, 0):\n'
         '            return None\n'
         '        ends = self._log_ends.get(kind, [])\n'
         '        start = bisect.bisect_right(self._log_rvs.get(kind, []), since_rv)\n'
         '        tail = (ends[-1] - (ends[start - 1] if start else 0)) if ends else 0\n'
         '        if 8 * tail > self._dirty_count(kind):\n'
         '            return None\n'
         '        names: set[str] = set()\n'
         '        for batch in self._log_names.get(kind, [])[start:]:\n'
         '            names.update(batch)\n'
         '        return names\n'
         '\n'
         '    def has_partitioned_dirty(self, kind: str) -> bool:\n'),
        ('            if tombs:\n'
         '                for name in names_sel:\n'
         '                    tombs.pop(name, None)\n'
         '            # per-queue event order matches the per-name loop (queues are\n',
         '            self._log_writes(kind, names_sel)\n'
         '            if tombs:\n'
         '                for name in names_sel:\n'
         '                    tombs.pop(name, None)\n'
         '            # per-queue event order matches the per-name loop (queues are\n'),
        ('                    if tombs:\n',
         '                    self._log_writes(kind, names_sel)\n'
         '                    if tombs:\n'),
        ('            if tombs:\n'
         '                for name in names_sel:\n'
         '                    tombs.pop(name, None)\n'
         '            for q, kinds in self._watchers_snapshot:\n',
         '            self._log_writes(kind, names_sel)\n'
         '            if tombs:\n'
         '                for name in names_sel:\n'
         '                    tombs.pop(name, None)\n'
         '            for q, kinds in self._watchers_snapshot:\n'),
        # the dirty-set probe filters the write log one dirty dict at a time, with no generator per name
        (
            '                dirty = [self._changed.get(kind, {}), *(parts or {}).values()]\n'
            '                changed = sorted(\n'
            '                    n for n in logged\n'
            '                    if any(d.get(n, 0) > since_rv for d in dirty)\n'
            '                )\n',
            '                keep: set[str] = set()\n'
            '                for d in (self._changed.get(kind, {}), *(parts or {}).values()):\n'
            '                    get = d.get\n'
            '                    keep.update([n for n in logged if get(n, 0) > since_rv])\n'
            '                changed = sorted(keep)\n',
        ),
    ],
    "policy/classes.py": [],
    "policy/fairshare.py": [],
    # the spans the benchmark's policy metrics read: ``policy.prepare``
    # (counters pending, deferred) and ``policy.backfill`` (candidates,
    # takes), each a thin wrapper over the unchanged pass
    "policy/engine.py": [
        (
            'from slurm_bridge_tpu_torch.policy.fairshare import FairShare, dominant_share\n'
            '\n',
            'from slurm_bridge_tpu_torch.policy.fairshare import FairShare, dominant_share\n'
            'from slurm_bridge_tpu_torch.obs.tracing import TRACER\n'
            '\n',
        ),
        (
            '    def prepare(\n'
            '        self, pending: list, incumbents: list\n',
            '    def prepare(\n'
            '        self, pending: list, incumbents: list\n'
            '    ) -> tuple[list, list, list[float]]:\n'
            '        """:meth:`_prepare` under the span ``policy.prepare``, which counts\n'
            '        the ``pending`` jobs and those ``deferred``: ordered behind a job\n'
            '        of a higher class."""\n'
            '        with TRACER.span("policy.prepare") as span:\n'
            '            out = self._prepare(pending, incumbents)\n'
            '            ranks = [rank for _tenant, _share, rank in self._tick_jobs]\n'
            '            top = max(ranks, default=0)\n'
            '            span.count("pending", len(ranks))\n'
            '            span.count("deferred", len(ranks) - ranks.count(top))\n'
            '        return out\n'
            '\n'
            '    def _prepare(\n'
            '        self, pending: list, incumbents: list\n',
        ),
        (
            '    ) -> list[tuple[int, int]]:\n'
            '        """Second-pass hole filling after the main solve.\n',
            '    ) -> list[tuple[int, int]]:\n'
            '        """:meth:`_backfill` under the span ``policy.backfill``, which counts\n'
            '        its ``candidates`` and its ``takes`` (the shard rows it placed)."""\n'
            '        with TRACER.span("policy.backfill") as span:\n'
            '            out = self._backfill(\n'
            '                snapshot, batch, placement, n_pending, rank_of=rank_of\n'
            '            )\n'
            '            span.count("candidates", self.backfill_candidates_last)\n'
            '            span.count("takes", len(out))\n'
            '        return out\n'
            '\n'
            '    def _backfill(\n'
            '        self, snapshot, batch, placement, n_pending: int, *, rank_of=None\n'
            '    ) -> list[tuple[int, int]]:\n'
            '        """Second-pass hole filling after the main solve.\n',
        ),
    ],
    "admission/__init__.py": [],
    "admission/residual.py": [],
    # the window install's span ``admission.window`` (counters protected,
    # deductions), which the benchmark's admission metrics read
    "admission/fastpath.py": [
        (
            'from slurm_bridge_tpu_torch.obs.metrics import REGISTRY, Histogram\n'
            'from slurm_bridge_tpu_torch.policy.classes import (\n',
            'from slurm_bridge_tpu_torch.obs.metrics import REGISTRY, Histogram\n'
            'from slurm_bridge_tpu_torch.obs.tracing import TRACER\n'
            'from slurm_bridge_tpu_torch.policy.classes import (\n',
        ),
        (
            '        Serialized against concurrent arrivals via :attr:`lock`."""\n'
            '        with self.lock:\n'
            '            self._begin_window_locked(snapshot, free_after, backlog, plan)\n',
            '        Serialized against concurrent arrivals via :attr:`lock`. The span\n'
            '        ``admission.window`` counts the ``protected`` gangs and the\n'
            '        in-flight ``deductions`` carried over into the new window."""\n'
            '        with TRACER.span("admission.window") as span, self.lock:\n'
            '            self._begin_window_locked(snapshot, free_after, backlog, plan)\n'
            '            span.count("protected", len(self.protected))\n'
            '            span.count("deductions", len(self.deductions))\n',
        ),
    ],
    "bridge/scheduler.py": [
        ("and solves the assignment with the JAX auction kernel (or the greedy packer",
         "and solves the assignment with the device auction, whose score/choose step\n"
         "is the hand-written ``bid_argmax`` kernel on the card (or the greedy packer"),
        # no grpc on the card's machine: the port's own RpcError
        ("import grpc\n", ""),
        ("from slurm_bridge_tpu_torch.wire import ServiceClient, pb",
         "from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, pb"),
        ("        except grpc.RpcError as e:\n            log.warning(\"remote Place",
         "        except RpcError as e:\n            log.warning(\"remote Place"),
        ("            except grpc.RpcError as e:\n                log.warning(\n",
         "            except RpcError as e:\n                log.warning(\n"),
        # the device keyword
        ('        explain_target: str = "",\n    ):\n',
         '        explain_target: str = "",\n        device=None,\n    ):\n'
         "        #: where the device auction runs: None is the card (or\n"
         '        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)\n'
         "        self.device = device\n"),
        # sharded auto-select counts the devices the mesh spans for the
        # scheduler's backend (parallel/mesh.py)
        ("        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n"
         "        from slurm_bridge_tpu_torch.solver.routing import use_sharded\n\n"
         "        ensure_backend()\n        import jax\n\n",
         "        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n"
         "        from slurm_bridge_tpu_torch.parallel.mesh import device_count\n"
         "        from slurm_bridge_tpu_torch.solver.routing import use_sharded\n\n"),
        ("snapshot.num_nodes, len(jax.devices()),\n",
         "snapshot.num_nodes,\n            device_count(ensure_backend(self.device)),\n"),
        # the auto route asks the scheduler's own device
        ("            route = choose_path(\n",
         "            from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n\n"
         "            route = choose_path(\n"),
        ("                snapshot.num_nodes,\n                gang_fraction=",
         "                snapshot.num_nodes,\n"
         "                backend_name=ensure_backend(self.device),\n"
         "                gang_fraction="),
        # the multi-device sweep runs on the scheduler's device
        ("                snapshot, batch, self.auction_config, incumbent=incumbent\n"
         "            )\n        else:\n",
         "                snapshot, batch, self.auction_config, incumbent=incumbent,\n"
         "                device=self.device,\n"
         "            )\n        else:\n"),
        ("                self._solver = DeviceSolver(snapshot, self.auction_config)\n",
         "                self._solver = DeviceSolver(\n"
         "                    snapshot, self.auction_config, device=self.device\n"
         "                )\n"),
        # each shard's device auction runs on the scheduler's device
        ("                    bucket=bucket,\n                )\n            )\n",
         "                    bucket=bucket,\n                    device=device,\n"
         "                )\n            )\n"),
        # spans for the tick's unnamed time (pending scan, inventory, prepare); the solve's host syncs
        ("from slurm_bridge_tpu_torch.solver import AuctionConfig, greedy_place\n",
         "from slurm_bridge_tpu_torch.solver import AuctionConfig, auction, greedy_place\n"),
        ("        self.last_phase_ms: dict[str, float] = {}\n",
         "        self.last_phase_ms: dict[str, float] = {}\n"
         "        #: host syncs of the last tick's local solve (``host_syncs`` on\n"
         "        #: its ``scheduler.solve`` span; ``solver.auction.note_sync``)\n"
         "        self.last_host_syncs = 0\n"),
        ('        self.last_phase_ms = {"store": 0.0, "encode": 0.0, "solve": 0.0, "bind": 0.0}\n',
         '        self.last_phase_ms = {"store": 0.0, "encode": 0.0, "solve": 0.0, "bind": 0.0}\n'
         "        self.last_host_syncs = 0\n"),
        ("            pods = self._pending_set()\n",
         '            with TRACER.span("scheduler.store.pending"):\n'
         "                pods = self._pending_set()\n"),
        ("                partitions, nodes = self.cluster_state()\n",
         '                with TRACER.span("scheduler.store.inventory"):\n'
         "                    partitions, nodes = self.cluster_state()\n"),
        ("        priorities = None\n"
         "        if self.policy is not None:\n"
         "            # the policy pass: class/tenant resolution, fair-share\n"
         "            # admission order, bounded preemption pool, per-job effective\n"
         "            # priorities the solver admits by (see policy/engine.py)\n"
         "            self.policy.begin_tick(nodes)\n"
         "            pods, incumbents, priorities = self.policy.prepare(\n"
         "                pods, incumbents\n"
         "            )\n"
         "        trail = self.explain_trail\n"
         "        t_idx = -1\n"
         "        if trail is not None:\n"
         "            for _j, _p in enumerate(pods):\n"
         "                if trail.matches(_p.name):\n"
         "                    t_idx = _j\n"
         '                    msg = f"pending in partition {_p.partition!r}"\n'
         "                    if priorities is not None:\n"
         "                        msg += (\n"
         '                            f", fair-share slot {_j} of {len(pods)}, "\n'
         '                            f"effective priority {priorities[_j]:g}"\n'
         "                        )\n"
         '                    trail.add("queue", msg)\n'
         "                    break\n"
         "        all_pods = pods + incumbents\n"
         "        demands: list[JobDemand] = []\n"
         "        for pod in all_pods:\n"
         "            d = pod.demand or JobDemand(partition=pod.partition)\n"
         "            demands.append(d)\n"
         "        n_pending = len(pods)\n",
         "        # the solve's inputs: the policy pass, the demand list (and,\n"
         '        # below, the warm-start key) — the first part of "other"\n'
         '        with TRACER.span("scheduler.prepare"):\n'
         "            priorities = None\n"
         "            if self.policy is not None:\n"
         "                # the policy pass: class/tenant resolution, fair-share\n"
         "                # admission order, bounded preemption pool, per-job effective\n"
         "                # priorities the solver admits by (see policy/engine.py)\n"
         "                self.policy.begin_tick(nodes)\n"
         "                pods, incumbents, priorities = self.policy.prepare(\n"
         "                    pods, incumbents\n"
         "                )\n"
         "            trail = self.explain_trail\n"
         "            t_idx = -1\n"
         "            if trail is not None:\n"
         "                for _j, _p in enumerate(pods):\n"
         "                    if trail.matches(_p.name):\n"
         "                        t_idx = _j\n"
         '                        msg = f"pending in partition {_p.partition!r}"\n'
         "                        if priorities is not None:\n"
         "                            msg += (\n"
         '                                f", fair-share slot {_j} of {len(pods)}, "\n'
         '                                f"effective priority {priorities[_j]:g}"\n'
         "                            )\n"
         '                        trail.add("queue", msg)\n'
         "                        break\n"
         "            all_pods = pods + incumbents\n"
         "            demands: list[JobDemand] = []\n"
         "            for pod in all_pods:\n"
         "                d = pod.demand or JobDemand(partition=pod.partition)\n"
         "                demands.append(d)\n"
         "            n_pending = len(pods)\n"),
        ("                memo_key = self._solve_key(all_pods, priorities, n_pending)\n",
         '                with TRACER.span("scheduler.prepare"):\n'
         "                    memo_key = self._solve_key(all_pods, priorities, n_pending)\n"),
        ("\n"
         '        with TRACER.span("scheduler.solve") as solve_span:\n',
         "\n"
         "        syncs0 = auction.HOST_SYNCS\n"
         '        with TRACER.span("scheduler.solve") as solve_span:\n'),
        ('            solve_span.count("shards", int(batch.num_shards))\n',
         '            solve_span.count("shards", int(batch.num_shards))\n'
         "            self.last_host_syncs = auction.HOST_SYNCS - syncs0\n"
         '            solve_span.count("host_syncs", self.last_host_syncs)\n'),
    ],
    "solver/encoder.py": [],
    "solver/native/greedy.cpp": [],
    "solver/native/indexed.cpp": [],
    "solver/snapshot.py": [
        ("a single jitted sweep", "a single batched sweep"),
        ("(TPU-first)", "(accelerator-first)"),
    ],
    "solver/greedy.py": [
        ("baseline the JAX solver's ≥10× target is measured against",
         "baseline the device auction is measured against"),
    ],
    "solver/nativelib.py": [
        ("with g++ -O3 and cached next to their source; a rebuild happens whenever\n"
         "the source is newer than the binary. One loader serves both so build\n"
         "flags, rebuild logic, and error surfacing cannot drift apart.",
         "with g++ -O3 into the package's build directory (:data:`BUILD_DIR`, never\n"
         "next to the sources); a rebuild happens whenever the source is newer than\n"
         "the binary. One loader serves both so build flags, rebuild logic, and\n"
         "error surfacing cannot drift apart."),
        ("import threading\n", "import threading\n\nfrom slurm_bridge_tpu_torch import BUILD_DIR\n"),
        ("    import time\n\n", "    import time\n\n    lib.parent.mkdir(parents=True, exist_ok=True)\n"),
    ],
    "solver/greedy_native.py": [
        ("from slurm_bridge_tpu_torch.solver.nativelib import (",
         "from slurm_bridge_tpu_torch import BUILD_DIR\n"
         "from slurm_bridge_tpu_torch.solver.nativelib import ("),
        ('pathlib.Path(__file__).parent / "native" / "libsbtgreedy.so"',
         'BUILD_DIR / "libsbtgreedy.so"'),
    ],
    "solver/indexed_native.py": [
        ("from slurm_bridge_tpu_torch.solver.nativelib import (",
         "from slurm_bridge_tpu_torch import BUILD_DIR\n"
         "from slurm_bridge_tpu_torch.solver.nativelib import ("),
        ('pathlib.Path(__file__).parent / "native" / "libsbtindexed.so"',
         'BUILD_DIR / "libsbtindexed.so"'),
    ],
    # ---- the job lifecycle on the simulated cluster ----
    "core/durations.py": [],
    "core/timeparse.py": [],
    "core/hostlist.py": [],
    "core/scontrol.py": [],
    "core/sbatch.py": [],
    "core/sacct.py": [],
    "core/__init__.py": [],
    # the schema is the port's own message table, not workload_pb2
    "wire/coldec.py": [
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import messages as pb\n"),
    ],
    "wire/convert.py": [
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import messages as pb\n"),
    ],
    "parallel/writeops.py": [],
    # fork hygiene: each worker closes the parent-side pipe ends it
    # inherits (its own and its elder siblings'), so a parent that dies
    # without reaping its pool leaves no worker blocked in recv() forever
    "parallel/colpool.py": [
        ("def _worker_main(conn) -> None:  # pragma: no cover - runs in the child\n",
         "def _worker_main(conn, inherited=()) -> None:  # pragma: no cover - runs in the child\n"
         "    # the parent's ends of this worker's pipe and of its elder\n"
         "    # siblings' pipes came along with the fork: holding them open\n"
         "    # would keep recv() below from ever seeing EOF once the parent\n"
         "    # is gone, and the orphan would live on holding the parent's\n"
         "    # inherited descriptors\n"
         "    for c in inherited:\n"
         "        c.close()\n"),
        ("                    proc = ctx.Process(\n"
         "                        target=_worker_main, args=(child,), daemon=True\n"
         "                    )\n",
         "                    proc = ctx.Process(\n"
         "                        target=_worker_main,\n"
         "                        args=(child, [parent, *self._conns]),\n"
         "                        daemon=True,\n"
         "                    )\n"),
    ],
    "bridge/controller.py": [],
    "bridge/operator.py": [
        # no span per reconciled job: sweep(settle=True) reconciles and counts its slow keys
        ("from slurm_bridge_tpu_torch.obs.tracing import TRACER, current_span\n",
         "from slurm_bridge_tpu_torch.obs.tracing import TRACER\n"),
        ("        t0 = time.perf_counter()\n"
         "        # join an active SAMPLED trace only: a controller-thread reconcile\n"
         "        # with no ambient span (production steady state) — or one inside a\n"
         "        # trace the sampler discarded — pays one contextvar read, not a\n"
         "        # span build per reconcile\n"
         "        ambient = current_span()\n"
         "        if ambient is not None and ambient.sampled:\n"
         '            with TRACER.span("operator.reconcile", job=job_name):\n'
         "                try:\n"
         "                    return self._reconcile(job_name)\n"
         "                finally:\n"
         "                    _reconcile_seconds.observe(time.perf_counter() - t0)\n",
         "        # no span per job: the controller thread's ``{name}.reconcile``\n"
         "        # span covers its keys, and the sweep counts the ones it settles\n"
         "        t0 = time.perf_counter()\n"),
        ("    def sweep(self, names) -> list[str]:\n",
         "    def sweep(self, names, *, settle: bool = False) -> list[str]:\n"),
        ("        oracle and the fallback for everything unusual.\n",
         "        oracle and the fallback for everything unusual. With ``settle``\n"
         "        the sweep does so itself, in order and inside its span (counted\n"
         "        as its ``reconciles`` and ``reconcile_ms``), and returns nothing.\n"),
        ("                return self._sweep_cols(span, names, jt, pt)\n"
         "            return self._sweep(span, names)\n",
         "                slow = self._sweep_cols(span, names, jt, pt)\n"
         "            else:\n"
         "                slow = self._sweep(span, names)\n"
         "            if not settle:\n"
         "                return slow\n"
         "            t0 = time.perf_counter()\n"
         "            for key in slow:\n"
         "                self.reconcile(key)\n"
         '            span.count("reconciles", len(slow))\n'
         '            span.count("reconcile_ms", (time.perf_counter() - t0) * 1e3)\n'
         "            return []\n"),
    ],
    # no grpc on the card's machine: the port's RpcError and StatusCode
    "bridge/vnode.py": [
        ("import grpc\nimport numpy as np\n", "import numpy as np\n"),
        ("from slurm_bridge_tpu_torch.wire import ServiceClient, pb\n",
         "from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, StatusCode, pb\n"),
        ("grpc.RpcError", "RpcError", 10),
        ("grpc.StatusCode", "StatusCode", 15),
        # the steady tick's mirror on the card's host (PERF.md §5): a
        # version-only JobsInfo answer decodes inline, not through the
        # worker pool ...
        ("#: requests per SubmitJobs batch",
         "#: JobsInfo answers up to this size decode inline rather than in the\n"
         "#: worker pool: a version field alone (the chunk unchanged since the\n"
         "#: cursor) is at most 11 bytes\n"
         "_INLINE_DECODE_BYTES = 16\n\n"
         "#: requests per SubmitJobs batch"),
        ("            if pool is not None:\n"
         "                results[i] = (\"raw\", raw)\n",
         "            if pool is not None and len(raw) > _INLINE_DECODE_BYTES:\n"
         "                # an answer with no entry (the chunk unchanged since the\n"
         "                # cursor) decodes here: cheaper than the pool round trips\n"
         "                results[i] = (\"raw\", raw)\n"),
        # ... a changed worker pod on the node keeps the scoped rescan ...
        ("                if i is None:\n"
         "                    return False  # new pod here: converge/classify\n",
         "                if i is None:\n"
         "                    if c.role[row] != PodRole.SIZECAR and not c.deleted[row]:\n"
         "                        # a worker pod here: never submitted, mirrored\n"
         "                        # or deleted by this provider, so the full\n"
         "                        # classification would not see it either\n"
         "                        continue\n"
         "                    return False  # new pod here: converge/classify\n"),
        # ... and a cursor pass over the same working set keeps its
        # applied-id set instead of rebuilding it
        ("        self._applied_ids: set[int] = set()\n",
         "        self._applied_ids: set[int] = set()\n"
         "        #: the working set ``_applied_ids`` was last built from: a cursor\n"
         "        #: pass over the same cache re-applies the same ids\n"
         "        self._applied_mc: _MirrorCache | None = None\n"),
        ("        self._applied_ids = set(mc.ids)\n",
         "        if mc is not self._applied_mc:\n"
         "            self._applied_ids = set(mc.ids)\n"
         "            self._applied_mc = mc\n"),
        # the mirror's working set patched for joins and leaves across churn syncs
        (
            'import dataclasses\n',
            'import bisect\n'
            'import dataclasses\n',
        ),
        (
            '    pass: names, per-pod job ids, and the stored row state to diff\n'
            '    against."""\n'
            '\n'
            '    names: list\n'
            '    job_ids: list\n'
            '    rv: np.ndarray\n'
            '    phase: np.ndarray\n'
            '    istart: np.ndarray\n',
            '    pass: names (name-sorted), per-pod job ids, and the stored row state\n'
            "    to diff against. The info segments' offsets are not kept: a heap\n"
            '    compaction moves them without a write, so the diff reads them under\n'
            '    its own lock."""\n'
            '\n'
            '    names: list\n'
            '    job_ids: list\n'
            '    rv: np.ndarray\n'
            '    phase: np.ndarray\n',
        ),
        (
            '    (``since_version`` is restamped per tick), and the job-id → batch\n'
            '    index map that routes an agent-reported change back to its pod.\n'
            "    Valid exactly while the store's Pod dirty-set stays empty; any pod\n"
            '    write (ours included) invalidates it and the next sync reclassifies.\n'
            '    """\n'
            '\n'
            '    rb: _RefreshBatch\n'
            '    ids: list\n'
            '    reqs: list\n'
            '    idx_of_jid: dict\n',
            '    (``since_version`` is restamped per tick), and the job-id → pod\n'
            '    names map that routes an agent-reported change back to its pod.\n'
            '    Each sync patches it for the pods written since the last one (see\n'
            '    :meth:`VirtualNodeProvider._rescope_mirror_cache`); a deletion, a\n'
            "    member moving off the node or a member's job ids moving drop it and\n"
            '    the node bucket is reclassified.\n'
            '    """\n'
            '\n'
            '    rb: _RefreshBatch\n'
            '    #: the unique job ids (int64), in request order\n'
            '    ids: np.ndarray\n'
            '    reqs: list\n'
            '    #: job id → names of the members holding it: keyed by name, so a\n'
            "    #: join or leave renumbers no other member's entry\n"
            '    names_of_jid: dict\n',
        ),
        (
            '\n'
            '#: gRPC codes meaning "the agent is unreachable / busy", not "the request\n',
            '    #: per id of ``ids``: True while no status response has been applied\n'
            '    #: for it — the source of ``full_chunk`` when a patch re-chunks\n'
            '    unapplied: np.ndarray\n'
            '\n'
            '\n'
            'def _splice(seq: list, drop: list, at: list, vals: list) -> list:\n'
            '    """``seq`` without the positions ``drop`` (ascending), with ``vals[k]``\n'
            '    inserted before old position ``at[k]`` (ascending): list slices\n'
            '    between the edits, so the Python-level work is O(edits)."""\n'
            '    out: list = []\n'
            '    lo = d = k = 0\n'
            '    while d < len(drop) or k < len(at):\n'
            '        if k < len(at) and (d == len(drop) or at[k] <= drop[d]):\n'
            '            out += seq[lo : at[k]]\n'
            '            out.append(vals[k])\n'
            '            lo = at[k]\n'
            '            k += 1\n'
            '        else:\n'
            '            out += seq[lo : drop[d]]\n'
            '            lo = drop[d] + 1\n'
            '            d += 1\n'
            '    out += seq[lo:]\n'
            '    return out\n'
            '\n'
            '\n'
            'def _full_chunks(unapplied: np.ndarray) -> list:\n'
            '    """Per ``_BULK_CHUNK`` chunk of an id list: whether it holds an id\n'
            '    with no status response applied yet (queried at since_version 0)."""\n'
            '    if not unapplied.size:\n'
            '        return []\n'
            '    starts = np.arange(0, unapplied.size, _BULK_CHUNK)\n'
            '    return np.logical_or.reduceat(unapplied, starts).tolist()\n'
            '\n'
            '\n'
            '#: gRPC codes meaning "the agent is unreachable / busy", not "the request\n',
        ),
        (
            '        self._mirror_cache: _MirrorCache | None = None\n',
            '        self._mirror_cache: _MirrorCache | None = None\n'
            '        #: the names the last sync submitted: the next one re-examines\n'
            '        #: them beside the dirty names, since a submit that failed\n'
            '        #: transiently leaves no store trace and must be retried\n'
            '        self._resubmit: list[str] = []\n'
            '        #: one incremental sync at a time: sync() runs concurrently (the\n'
            '        #: partition ticker and sync_now callers), and the cursor, the kept\n'
            '        #: working set and the status passes over it move together\n'
            '        self._sync_lock = threading.RLock()\n',
        ),
        (
            '        #: pins classification work ∝ changed names, not O(cluster)\n'
            '        self.mirror_scans_full = 0\n'
            '        self.mirror_scans_scoped = 0\n'
            '        self.mirror_scoped_rows = 0\n'
            '        #: agent-side cursors: jobs-state / nodes-state versions last\n'
            '        #: fully applied (0 = no cursor yet → full responses)\n'
            '        self._jobs_cursor = 0\n'
            '        #: job ids a status response has actually been APPLIED for — the\n'
            '        #: cursor is only trusted for these; anything else queries full\n'
            '        self._applied_ids: set[int] = set()\n'
            '        #: the working set ``_applied_ids`` was last built from: a cursor\n'
            '        #: pass over the same cache re-applies the same ids\n'
            '        self._applied_mc: _MirrorCache | None = None\n',
            '        #: pins classification work ∝ changed names, not O(cluster) —\n'
            '        #: and the live pods the patches added to and took out of the\n'
            '        #: working set\n'
            '        self.mirror_scans_full = 0\n'
            '        self.mirror_scans_scoped = 0\n'
            '        self.mirror_scoped_rows = 0\n'
            '        self.mirror_patched_joins = 0\n'
            '        self.mirror_patched_leaves = 0\n'
            '        #: agent-side cursors: jobs-state / nodes-state versions last\n'
            '        #: fully applied (0 = no cursor yet → full responses)\n'
            '        self._jobs_cursor = 0\n'
            '        #: job ids a status response has actually been APPLIED for — the\n'
            '        #: cursor is only trusted for these; anything else queries full\n'
            '        self._applied_ids: set[int] = set()\n',
        ),
        (
            '                self._sync_cols(table, span, t0)\n',
            '                if self.incremental:\n'
            '                    with self._sync_lock:\n'
            '                        self._sync_cols(table, span, t0)\n'
            '                else:\n'
            '                    self._sync_cols(table, span, t0)\n',
        ),
        (
            '        classification (full, scoped, or skipped via the dirty-set),\n',
            '        classification (full, patched, or skipped via the dirty-set),\n',
        ),
        (
            '        if self.incremental:\n'
            '            rv, changed, deleted = self.store.changes_since(\n'
            '                Pod.KIND, self._scan_rv\n'
            '            )\n'
            '            mc = self._mirror_cache\n'
            '            if not changed and not deleted and mc is not None:\n'
            '                span.count("converge_pods", 0)\n'
            '                span.count("refresh_pods", len(mc.rb.names))\n'
            '                return "incr", mc\n'
            '            if mc is not None and self._rescope_mirror_cache(\n'
            '                table, mc, changed, deleted\n'
            '            ):\n'
            '                # satellite a: the dirty names were either foreign pods\n'
            "                # (other providers' — the O(cluster)-per-write trap) or\n"
            '                # membership-preserving status moves, patched in place —\n'
            '                # classification work was ∝ changed names, and the\n'
            '                # cursor sync below reuses the SAME working set\n'
            '                self._scan_rv = rv\n'
            '                span.count("converge_pods", 0)\n'
            '                span.count("refresh_pods", len(mc.rb.names))\n'
            '                return "incr", mc\n'
            '            self._scan_rv = rv\n'
            '            self._mirror_cache = None\n'
            '            self.mirror_scans_full += 1\n'
            '        c = table.cols\n'
            '        with self.store.locked():\n'
            '            # names→rows resolved under the SAME lock hold as the column\n'
            '            # reads: a delete+create between the two would recycle a row\n'
            "            # index and pair a name with another pod's columns\n"
            '            names, rows = self.store.rows_by_node(Pod.KIND, self.node_name)\n'
            '            if not names:\n'
            '                span.count("converge_pods", 0)\n'
            '                span.count("refresh_pods", 0)\n'
            '                now = time.perf_counter()\n'
            '                _status_seconds.observe(0.0)\n'
            '                _sync_seconds.observe(now - t0)\n'
            '                return "done", None\n'
            '            deleted = c.deleted[rows]\n'
            '            sizecar = c.role[rows] == PodRole.SIZECAR\n'
            '            njobs = c.njobs[rows]\n'
            '            phase = c.phase[rows]\n'
            '            rv = c.rv[rows]\n'
            '            live = (\n'
            '                sizecar\n'
            '                & ~deleted\n'
            '                & (njobs > 0)\n'
            '                & (phase != _PH_SUCCEEDED)\n'
            '                & (phase != _PH_FAILED)\n'
            '            )\n'
            '            submit_mask = sizecar & ~deleted & (njobs == 0)\n'
            '            items: list[_SubmitItem] = []\n'
            '            for i in np.nonzero(submit_mask)[0].tolist():\n'
            '                row = int(rows[i])\n'
            '                ann = c.ann[row]\n'
            '                items.append(_SubmitItem(\n'
            '                    names[i], c.demand[row], c.uid[row],\n'
            '                    ann.get("submit-generation", ""), c.hint[row],\n'
            '                    int(rv[i]), c.labels[row], ann,\n'
            '                ))\n'
            '            ri = np.nonzero(live)[0]\n'
            '            rrows = rows[ri]\n'
            '            refresh = _RefreshBatch(\n'
            '                names=[names[i] for i in ri.tolist()],\n'
            '                job_ids=[c.job_ids[int(r)] for r in rrows.tolist()],\n'
            '                rv=rv[ri],\n'
            '                phase=phase[ri],\n'
            '                istart=c.istart[rrows],\n'
            '                ilen=c.ilen[rrows],\n'
            '            )\n'
            '            work_names = [names[i] for i in np.nonzero(deleted)[0].tolist()]\n',
            '        mc = None\n'
            '        with TRACER.span("vnode.classify"):\n'
            '            if not self.incremental:\n'
            '                items, work_names, refresh = self._classify_full(table)\n'
            '            else:\n'
            '                with self._sync_lock:\n'
            '                    items, work_names, refresh, mc = self._classify_incr(\n'
            '                        table, span\n'
            '                    )\n'
            '                    # a terminate that failed transiently leaves no store\n'
            '                    # trace either: the full classification retries it\n'
            '                    self._mirror_cache = mc if not work_names else None\n'
            '                    self._resubmit = [it.name for it in items]\n'
            '        if refresh is None:\n'
            '            span.count("converge_pods", 0)\n'
            '            span.count("refresh_pods", 0)\n'
            '            now = time.perf_counter()\n'
            '            _status_seconds.observe(0.0)\n'
            '            _sync_seconds.observe(now - t0)\n'
            '            return "done", None\n',
        ),
        (
            '            mc = self._build_mirror_cache(refresh)\n'
            '            # the cache survives to the next tick ONLY when this sync had\n'
            '            # no per-pod converge work: a submit that failed TRANSIENTLY\n'
            '            # (agent unavailable) leaves no store trace, and a cached\n'
            '            # steady skip would silently drop the level-triggered retry\n'
            '            # the full mirror repeats every sync. A successful converge\n'
            '            # wrote job ids anyway, so the next tick reclassifies either\n'
            '            # way — one extra O(pods-on-node) pass per converge tick.\n'
            '            self._mirror_cache = (\n'
            '                mc if not items and not work_names else None\n'
            '            )\n'
            '            return "incr", mc\n'
            '        return "full", refresh\n'
            '\n'
            '    def _rescope_mirror_cache(\n'
            '        self, table, mc: _MirrorCache, changed, deleted\n'
            '    ) -> bool:\n',
            '            return "incr", mc\n'
            '        return "full", refresh\n'
            '\n'
            '    def _classify_incr(self, table, span):\n'
            '        """The incremental classification: ``(items, work_names,\n'
            "        refresh, mirror cache)``. Consults the store's Pod dirty-set\n"
            '        first: with nothing written and nothing to resubmit, the kept\n'
            '        working set drives the cursor sync as it is; otherwise it is\n'
            '        patched for the written names, and only what the patch refuses\n'
            '        reclassifies the node bucket."""\n'
            '        rv, changed, deleted = self.store.changes_since(\n'
            '            Pod.KIND, self._scan_rv\n'
            '        )\n'
            '        mc = self._mirror_cache\n'
            '        if mc is not None:\n'
            '            if not changed and not deleted and not self._resubmit:\n'
            '                return [], [], mc.rb, mc\n'
            '            patched = self._rescope_mirror_cache(\n'
            '                table, mc, changed, deleted, span\n'
            '            )\n'
            '            if patched is not None:\n'
            '                self._scan_rv = rv\n'
            '                mc, items = patched\n'
            '                return items, [], mc.rb, mc\n'
            '        self._scan_rv = rv\n'
            '        self.mirror_scans_full += 1\n'
            '        span.set_tag("scan", "full")\n'
            '        items, work_names, refresh = self._classify_full(table)\n'
            '        if refresh is None:\n'
            '            return items, work_names, None, None\n'
            '        mc = self._build_mirror_cache(refresh)\n'
            '        # ids that left the working set stop counting as applied\n'
            '        self._applied_ids.intersection_update(mc.ids.tolist())\n'
            '        return items, work_names, refresh, mc\n'
            '\n'
            '    @staticmethod\n'
            '    def _submit_item(c, name: str, row: int) -> _SubmitItem:\n'
            '        ann = c.ann[row]\n'
            '        return _SubmitItem(\n'
            '            name, c.demand[row], c.uid[row],\n'
            '            ann.get("submit-generation", ""), c.hint[row],\n'
            '            int(c.rv[row]), c.labels[row], ann,\n'
            '        )\n'
            '\n'
            '    def _classify_full(self, table):\n'
            '        """One pass over the provider\'s whole node bucket: ``(submit\n'
            '        items, deletion names, refresh batch)``, each in name order; the\n'
            '        refresh batch is None when the bucket is empty."""\n'
            '        c = table.cols\n'
            '        with self.store.locked():\n'
            '            # names→rows resolved under the SAME lock hold as the column\n'
            '            # reads: a delete+create between the two would recycle a row\n'
            "            # index and pair a name with another pod's columns\n"
            '            names, rows = self.store.rows_by_node(Pod.KIND, self.node_name)\n'
            '            if not names:\n'
            '                return [], [], None\n'
            '            deleted = c.deleted[rows]\n'
            '            sizecar = c.role[rows] == PodRole.SIZECAR\n'
            '            njobs = c.njobs[rows]\n'
            '            phase = c.phase[rows]\n'
            '            rv = c.rv[rows]\n'
            '            live = (\n'
            '                sizecar\n'
            '                & ~deleted\n'
            '                & (njobs > 0)\n'
            '                & (phase != _PH_SUCCEEDED)\n'
            '                & (phase != _PH_FAILED)\n'
            '            )\n'
            '            submit_mask = sizecar & ~deleted & (njobs == 0)\n'
            '            items = [\n'
            '                self._submit_item(c, names[i], int(rows[i]))\n'
            '                for i in np.nonzero(submit_mask)[0].tolist()\n'
            '            ]\n'
            '            ri = np.nonzero(live)[0]\n'
            '            rrows = rows[ri]\n'
            '            refresh = _RefreshBatch(\n'
            '                names=[names[i] for i in ri.tolist()],\n'
            '                job_ids=[c.job_ids[int(r)] for r in rrows.tolist()],\n'
            '                rv=rv[ri],\n'
            '                phase=phase[ri],\n'
            '                ilen=c.ilen[rrows],\n'
            '            )\n'
            '            work_names = [names[i] for i in np.nonzero(deleted)[0].tolist()]\n'
            '        return items, work_names, refresh\n'
            '\n'
            '    def _rescope_mirror_cache(\n'
            '        self, table, mc: _MirrorCache, changed, deleted, span\n'
            '    ):\n',
        ),
        (
            '        Exactly the membership-preserving cases are handled in place —\n'
            "        a live member's rv/phase/status-row moved (our own mirror\n"
            '        writes, agent transitions short of terminal), and writes to\n'
            '        pods on OTHER nodes, which this provider previously paid an\n'
            '        O(bucket) rescan for despite owning none of them. Anything that\n'
            '        changes membership or needs converge work — a new\n'
            '        submit-eligible pod on this node, a deletion, a terminal\n'
            '        transition, moved job ids — returns False and the caller runs\n'
            '        the full classification, as before.\n'
            '        """\n'
            '        idx_of = mc.idx_of_name\n'
            '        for name in deleted:\n'
            '            if name in idx_of:\n'
            '                return False  # tombstoned member: membership change\n'
            '        rb = mc.rb\n'
            '        with self.store.locked():\n'
            '            c = table.cols\n'
            '            row_of = table.row_of\n'
            '            for name in changed:\n'
            '                row = row_of.get(name)\n'
            '                node = c.node[row] if row is not None else None\n'
            '                if node != self.node_name:\n'
            '                    if name in idx_of:\n'
            '                        return False  # moved off this node\n'
            "                    continue  # another provider's pod: not our work\n"
            '                i = idx_of.get(name)\n'
            '                if i is None:\n'
            '                    if c.role[row] != PodRole.SIZECAR and not c.deleted[row]:\n'
            '                        # a worker pod here: never submitted, mirrored\n'
            '                        # or deleted by this provider, so the full\n'
            '                        # classification would not see it either\n'
            '                        continue\n'
            '                    return False  # new pod here: converge/classify\n'
            '                if (\n'
            '                    c.deleted[row]\n'
            '                    or c.role[row] != PodRole.SIZECAR\n'
            '                    or c.njobs[row] == 0\n'
            '                    or c.phase[row] == _PH_SUCCEEDED\n'
            '                    or c.phase[row] == _PH_FAILED\n'
            '                    or c.job_ids[row] != rb.job_ids[i]\n'
            '                ):\n'
            '                    return False  # left the live set / ids moved\n'
            '                rb.rv[i] = c.rv[row]\n'
            '                rb.phase[i] = c.phase[row]\n'
            '                rb.istart[i] = c.istart[row]\n'
            '                rb.ilen[i] = c.ilen[row]\n'
            '                self.mirror_scoped_rows += 1\n'
            '        self.mirror_scans_scoped += 1\n'
            '        return True\n',
            '        The names the last sync submitted are re-examined too: a submit\n'
            '        that failed transiently leaves no store trace. Returns ``(mirror\n'
            '        cache, submit items)``, or None when the full classification\n'
            '        must run.\n'
            '\n'
            '        Handled here, each the way the full classification would see it:\n'
            '        writes to pods on OTHER nodes (ignored), worker pods here\n'
            "        (ignored), a live member's rv/phase/status-row moves (patched in\n"
            '        place), a submit-eligible pod here (a submit item), a live pod\n'
            '        new to the set (a join: inserted at its name-sorted place, its\n'
            '        ids appended to the id list — mostly the pods this provider\n'
            '        submitted last sync), a member turned SUCCEEDED or FAILED (a\n'
            '        leave: taken out with the ids no other member holds). A deletion\n'
            "        here, a member moving off the node and a member's job ids moving\n"
            '        return None. The work is O(changed names + joins + leaves) in\n'
            '        Python; what is O(members) is list slicing and array work.\n'
            '        """\n'
            '        idx_of = mc.idx_of_name\n'
            '        if not idx_of.keys().isdisjoint(deleted):\n'
            '            return None  # tombstoned member: membership change\n'
            "        # the last sync's submits, unless written since (``changed`` is\n"
            '        # name-sorted)\n'
            '        probe = changed + [\n'
            '            n for n in self._resubmit\n'
            '            if (k := bisect.bisect_left(changed, n)) == len(changed)\n'
            '            or changed[k] != n\n'
            '        ]\n'
            '        rb = mc.rb\n'
            '        items: list[tuple[str, int]] = []\n'
            '        joins: list[tuple[str, int]] = []\n'
            '        leaves: list[int] = []\n'
            '        moved: list[int] = []  # batch indices of in-place patches\n'
            '        moved_rows: list[int] = []\n'
            '        with self.store.locked():\n'
            '            c = table.cols\n'
            '            rows = table.rows_for(probe)\n'
            '            found = rows >= 0\n'
            '            here = found & (c.node[np.where(found, rows, 0)] == self.node_name)\n'
            '            away = np.asarray(probe, dtype=object)[~here]\n'
            '            if not idx_of.keys().isdisjoint(away):\n'
            '                return None  # a member moved off this node\n'
            '            hk = np.flatnonzero(here)\n'
            '            hrows = rows[hk]\n'
            '            if c.deleted[hrows].any():\n'
            '                return None  # deletion work: converge/classify\n'
            '            sizecar = (c.role[hrows] == PodRole.SIZECAR).tolist()\n'
            '            njobs = c.njobs[hrows].tolist()\n'
            '            ph = c.phase[hrows]\n'
            '            terminal = ((ph == _PH_SUCCEEDED) | (ph == _PH_FAILED)).tolist()\n'
            '            hrows_l = hrows.tolist()\n'
            '            for k, x in enumerate(hk.tolist()):\n'
            '                name, row = probe[x], hrows_l[k]\n'
            '                i = idx_of.get(name)\n'
            '                if i is None:\n'
            '                    if not sizecar[k]:\n'
            '                        # a worker pod here: never submitted, mirrored or\n'
            '                        # deleted by this provider, so the full\n'
            '                        # classification would not see it either\n'
            '                        continue\n'
            '                    if njobs[k] == 0:\n'
            '                        items.append((name, row))\n'
            '                    elif not terminal[k]:\n'
            '                        joins.append((name, row))\n'
            '                    continue\n'
            '                if (\n'
            '                    not sizecar[k]\n'
            '                    or njobs[k] == 0\n'
            '                    or c.job_ids[row] != rb.job_ids[i]\n'
            '                ):\n'
            '                    return None  # ids moved\n'
            '                if terminal[k]:\n'
            '                    leaves.append(i)\n'
            '                else:\n'
            '                    moved.append(i)\n'
            '                    moved_rows.append(row)\n'
            '            if moved:\n'
            '                rb.rv[moved] = c.rv[moved_rows]\n'
            '                rb.phase[moved] = c.phase[moved_rows]\n'
            '                rb.ilen[moved] = c.ilen[moved_rows]\n'
            '            items.sort()\n'
            '            submit = [self._submit_item(c, n, r) for n, r in items]\n'
            '            if joins or leaves:\n'
            '                mc = self._patch_members(c, mc, joins, leaves)\n'
            '        self.mirror_scans_scoped += 1\n'
            '        self.mirror_scoped_rows += len(moved)\n'
            '        self.mirror_patched_joins += len(joins)\n'
            '        self.mirror_patched_leaves += len(leaves)\n'
            '        span.set_tag("scan", "patched")\n'
            '        span.count("joins", len(joins))\n'
            '        span.count("leaves", len(leaves))\n'
            '        return mc, submit\n'
            '\n'
            '    def _patch_members(\n'
            '        self, c, mc: _MirrorCache, joins: list, leaves: list\n'
            '    ) -> _MirrorCache:\n'
            '        """A new working set from ``mc`` with the ``joins`` (``(name,\n'
            '        row)``) inserted and the members at ``leaves`` taken out — what\n'
            '        the full classification would build, id set and chunk count\n'
            '        included. Call with the store lock held."""\n'
            '        rb = mc.rb\n'
            '        joins.sort()\n'
            '        leaves.sort()\n'
            '        jnames = [n for n, _ in joins]\n'
            '        jrows = np.asarray([r for _, r in joins], np.int64)\n'
            '        jids = [c.job_ids[r] for r in jrows.tolist()]\n'
            '        at = [bisect.bisect_left(rb.names, n) for n in jnames]\n'
            '        drop = np.asarray(leaves, np.intp)\n'
            '        pos = np.asarray(at, np.intp) - np.searchsorted(drop, at)\n'
            '\n'
            '        def arr(a, col):\n'
            '            return np.insert(np.delete(a, drop), pos, col[jrows])\n'
            '\n'
            '        names = _splice(rb.names, leaves, at, jnames)\n'
            '        new_rb = _RefreshBatch(\n'
            '            names=names,\n'
            '            job_ids=_splice(rb.job_ids, leaves, at, jids),\n'
            '            rv=arr(rb.rv, c.rv),\n'
            '            phase=arr(rb.phase, c.phase),\n'
            '            ilen=arr(rb.ilen, c.ilen),\n'
            '        )\n'
            "        # the id list: a leave's ids go when no other member holds them,\n"
            "        # a join's new ids are appended (never applied: full chunks). The\n"
            '        # routes are copied, not edited: a concurrent sync may still be\n'
            '        # applying a status pass over ``mc``\n'
            '        names_of = dict(mc.names_of_jid)\n'
            '        gone: list[int] = []\n'
            '        for i in leaves:\n'
            '            name = rb.names[i]\n'
            '            for jid in rb.job_ids[i]:\n'
            '                held = names_of.pop(jid)\n'
            '                if held != (name,):\n'
            '                    rest = tuple(n for n in held if n != name)\n'
            '                    if rest:\n'
            '                        names_of[jid] = rest\n'
            '                        continue\n'
            '                gone.append(jid)\n'
            '        added: list[int] = []\n'
            '        for name, jt in zip(jnames, jids):\n'
            '            for jid in jt:\n'
            '                held = names_of.get(jid)\n'
            '                if held is None:\n'
            '                    names_of[jid] = (name,)\n'
            '                    added.append(jid)\n'
            '                else:\n'
            '                    names_of[jid] = held + (name,)\n'
            '        applied = self._applied_ids\n'
            '        applied.difference_update(gone)\n'
            '        ids, unapplied, reqs = mc.ids, mc.unapplied, mc.reqs\n'
            '        first = ids.size\n'
            '        if gone:\n'
            '            g = np.sort(np.asarray(gone, np.int64))\n'
            '            keep = g[np.minimum(np.searchsorted(g, ids), g.size - 1)] != ids\n'
            '            first = int(np.argmin(keep))\n'
            '            ids, unapplied = ids[keep], unapplied[keep]\n'
            '        if added:\n'
            '            ids = np.concatenate([ids, np.asarray(added, np.int64)])\n'
            '            unapplied = np.concatenate([\n'
            '                unapplied,\n'
            '                np.fromiter((j not in applied for j in added), bool, len(added)),\n'
            '            ])\n'
            '        if gone or added:\n'
            '            # the chunks before the first edit hold the same ids\n'
            '            k0 = first // _BULK_CHUNK\n'
            '            reqs = reqs[:k0] + [\n'
            '                pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK].tolist())\n'
            '                for lo in range(k0 * _BULK_CHUNK, ids.size, _BULK_CHUNK)\n'
            '            ]\n'
            '        return _MirrorCache(\n'
            '            new_rb, ids, reqs, names_of, _full_chunks(unapplied),\n'
            '            dict(zip(names, range(len(names)))), unapplied,\n'
            '        )\n',
        ),
        (
            '        sequences identical between modes), and the jid → batch-index\n'
            '        route."""\n'
            '        applied = self._applied_ids\n'
            '        old_ids: list[int] = []\n'
            '        new_ids: list[int] = []\n'
            '        seen: set[int] = set()\n'
            '        idx_of: dict[int, tuple] = {}\n'
            '        for i, jt in enumerate(rb.job_ids):\n'
            '            for jid in jt:\n'
            '                if jid not in seen:\n'
            '                    seen.add(jid)\n'
            '                    (old_ids if jid in applied else new_ids).append(jid)\n'
            '                prev = idx_of.get(jid)\n'
            '                idx_of[jid] = (i,) if prev is None else prev + (i,)\n'
            '        ids = old_ids + new_ids\n'
            '        reqs = [\n'
            '            pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK])\n'
            '            for lo in range(0, len(ids), _BULK_CHUNK)\n'
            '        ]\n'
            '        n_old = len(old_ids)\n'
            '        full_chunk = [\n'
            '            lo + _BULK_CHUNK > n_old and lo < len(ids)\n'
            '            for lo in range(0, len(ids), _BULK_CHUNK)\n'
            '        ]\n'
            '        idx_of_name = {name: i for i, name in enumerate(rb.names)}\n'
            '        return _MirrorCache(rb, ids, reqs, idx_of, full_chunk, idx_of_name)\n',
            '        sequences identical between modes), and the jid → member names\n'
            '        route."""\n'
            '        applied = self._applied_ids\n'
            '        old_ids: list[int] = []\n'
            '        new_ids: list[int] = []\n'
            '        names_of: dict[int, tuple] = {}\n'
            '        for name, jt in zip(rb.names, rb.job_ids):\n'
            '            for jid in jt:\n'
            '                prev = names_of.get(jid)\n'
            '                if prev is None:\n'
            '                    names_of[jid] = (name,)\n'
            '                    (old_ids if jid in applied else new_ids).append(jid)\n'
            '                else:\n'
            '                    names_of[jid] = prev + (name,)\n'
            '        ids = old_ids + new_ids\n'
            '        reqs = [\n'
            '            pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK])\n'
            '            for lo in range(0, len(ids), _BULK_CHUNK)\n'
            '        ]\n'
            '        unapplied = np.zeros(len(ids), bool)\n'
            '        unapplied[len(old_ids) :] = True\n'
            '        idx_of_name = {name: i for i, name in enumerate(rb.names)}\n'
            '        return _MirrorCache(\n'
            '            rb, np.asarray(ids, np.int64), reqs, names_of,\n'
            '            _full_chunks(unapplied), idx_of_name, unapplied,\n'
            '        )\n',
        ),
        (
            '        if mc is not self._applied_mc:\n'
            '            self._applied_ids = set(mc.ids)\n'
            '            self._applied_mc = mc\n'
            '        # every id in the working set is now applied: later passes over\n'
            '        # the SAME cache must query every chunk at the cursor — leaving a\n'
            '        # tail chunk flagged "full" would re-deliver its ~2000 unchanged\n'
            '        # entries every steady tick (decode cost for nothing)\n',
            '        # the classification already dropped the ids that left the set\n'
            '        self._applied_ids.update(mc.ids[mc.unapplied].tolist())\n'
            '        # every id in the working set is now applied: later passes over\n'
            '        # the SAME cache must query every chunk at the cursor — leaving a\n'
            '        # tail chunk flagged "full" would re-deliver its ~2000 unchanged\n'
            '        # entries every steady tick (decode cost for nothing)\n'
            '        mc.unapplied[:] = False\n',
        ),
        (
            '        for jid in row_of_jid:\n'
            '            for i in mc.idx_of_jid.get(jid, ()):\n',
            '        idx_of = mc.idx_of_name\n'
            '        for jid in row_of_jid:\n'
            '            for name in mc.names_of_jid.get(jid, ()):\n'
            '                i = idx_of[name]\n',
        ),
    ],
    "bridge/configurator.py": [],
    "obs/flight.py": [
        # docstrings: spans mark phases and batches, none per object
        ("behind.\n",
         "behind.\n"
         "\n"
         "Spans mark phases and batches, never single objects: the operator's sweep\n"
         "counts the reconciles it drives (``reconciles``, ``reconcile_ms``) rather\n"
         "than opening a span per job, so a churn tick records about a hundred\n"
         "spans, not one per finished or unsettled job.\n"),
        ("        #: per-path/per-name rollups below at export time, so a 500k-span\n"
         "        #: storm tick overflowing the ring still produces exact path\n"
         "        #: totals and the phase-sum reconciliation holds at any scale.\n",
         "        #: per-path/per-name rollups below at export time, so a storm\n"
         "        #: tick of RPC chunks overflowing the ring still produces exact\n"
         "        #: path totals and the phase-sum reconciliation holds at any scale.\n"),
        ("        # cold tick (sim.arrive/operator.reconcile — 50k reconciles at\n",
         "        # cold tick (sim.arrive/sim.arrive.create — 50k creates at\n"),
    ],
    "policy/score.py": [],
    "policy/__init__.py": [],
    "shard/planner.py": [],
    "sim/trace.py": [],
    "sim/invariants.py": [],
    "sim/agent.py": [
        ("so the bridge's grpc error handling", "so the bridge's RPC error handling"),
        ("            import grpc\n",
         "            from slurm_bridge_tpu_torch.wire import StatusCode\n", 2),
        ("grpc.StatusCode.NOT_FOUND", "StatusCode.NOT_FOUND", 2),
    ],
    # SimRpcError is the port's RpcError
    "sim/faults.py": [
        ("a real ``grpc.RpcError`` so every production",
         "the port's ``RpcError``, so every production"),
        ("import grpc\n",
         "from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode\n"),
        ("class SimRpcError(grpc.RpcError):", "class SimRpcError(RpcError):"),
        ("        super().__init__(details)\n", "        super().__init__(code, details)\n"),
        ("grpc.StatusCode", "StatusCode", 4),
    ],
    "sim/harness.py": [
        ("import grpc\nimport numpy as np\n", "import numpy as np\n"),
        ("from slurm_bridge_tpu_torch.parallel import colpool\n",
         "from slurm_bridge_tpu_torch.parallel import colpool\n"
         "from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n"),
        ("from slurm_bridge_tpu_torch.wire.rpc import RetryingClient, RetryPolicy\n",
         "from slurm_bridge_tpu_torch.wire.errors import RpcError\n"
         "from slurm_bridge_tpu_torch.wire.rpc import RetryingClient, RetryPolicy\n"),
        ("grpc.RpcError", "RpcError", 7),
        # the device keyword, checked before anything is built
        ("    def __init__(self, scenario: Scenario):\n"
         "        _quiet_event_logs()\n"
         "        self.scenario = scenario\n",
         "    def __init__(self, scenario: Scenario, device=None):\n"
         "        _quiet_event_logs()\n"
         "        self.scenario = scenario\n"
         "        #: where the scheduler's device auction runs: None is the card\n"
         '        #: (or SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)\n'
         "        self.device = device\n"
         "        ensure_backend(device)\n"),
        ("            explain_target=scenario.explain_target,\n        )\n",
         "            explain_target=scenario.explain_target,\n"
         "            device=self.device,\n        )\n"),
        ("def run_scenario(scenario: Scenario) -> ScenarioResult:\n"
         "    return SimHarness(scenario).run()\n",
         "def run_scenario(scenario: Scenario, device=None) -> ScenarioResult:\n"
         "    return SimHarness(scenario, device=device).run()\n"),
        # the between-tick collection scans only what the tick allocated
        # (PERF.md §5): a full one re-scanned the store's million live
        # objects every tick at the quality scenarios' widths; same work,
        # same digests
        ("                gc.collect()\n", "                _collect_young()\n", 2),
        ("class SimHarness:\n",
         "def _collect_young() -> None:\n"
         '    """The between-tick collection over what the tick allocated: the\n'
         "    survivors join the frozen heap, so the next one does not re-scan the\n"
         "    store's million live objects (a full collection took ~0.4 s a tick\n"
         "    at the 80-scale quality scenarios on an 8-core host). Cycles that\n"
         '    reach into the frozen heap wait for ``run``\'s ``gc.unfreeze``."""\n'
         "    gc.collect()\n"
         "    gc.freeze()\n"
         "\n"
         "\n"
         "class SimHarness:\n"),
        # phases and their parts from the spans' own durations; the sweep settles its keys; the fetch wait's span
        ("            for key in self.operator.sweep(names):\n"
         "                self.operator.reconcile(key)\n",
         "            self.operator.sweep(names, settle=True)\n"),
        ("            for owner in self.operator.sweep(owners) if owners else ():\n"
         "                self.operator.reconcile(owner)\n",
         "            if owners:\n"
         "                self.operator.sweep(owners, settle=True)\n"),
        ("                apply_fn(fut.result())\n",
         '                with TRACER.span("sim.mirror.fetch_wait"):\n'
         "                    fetched = fut.result()\n"
         "                apply_fn(fetched)\n"),
        ("\n"
         "        t0 = time.perf_counter()\n"
         "        self._fast_bound_tick = []\n",
         "\n"
         "        # the phase clock is the spans' own: arrive's span, and the spans\n"
         "        # the scheduler tick and the mirror close on this thread, tallied\n"
         "        self._fast_bound_tick = []\n"),
        ("        arrive_ms = (time.perf_counter() - t0) * 1e3\n",
         "        arrive_ms = arrive_span.duration * 1e3\n"),
        ("        t1 = time.perf_counter()\n"
         "        if self._stack_up:\n"
         "            try:\n"
         "                self.scheduler.tick()\n"
         "            except RpcError:\n"
         '                self._rpc_fail("scheduler.tick")\n'
         "        sched_ms = (time.perf_counter() - t1) * 1e3\n",
         "        with TRACER.tally() as sched:\n"
         "            if self._stack_up:\n"
         "                try:\n"
         "                    self.scheduler.tick()\n"
         "                except RpcError:\n"
         '                    self._rpc_fail("scheduler.tick")\n'
         '        sched_ms = sched.get("scheduler.tick", 0.0)\n'),
        ("        t2 = time.perf_counter()\n"
         "        if self._stack_up:\n"
         "            self._mirror()\n"
         '        phases["mirror"] = (time.perf_counter() - t2) * 1e3\n',
         "        with TRACER.tally() as mirror:\n"
         "            if self._stack_up:\n"
         "                self._mirror()\n"
         '        phases["mirror"] = mirror.get("sim.mirror", 0.0)\n'),
        ('        phases["other"] = max(0.0, sched_ms - accounted)\n',
         '        phases["other"] = max(0.0, sched_ms - accounted)\n'
         "\n"
         "        # parts of the phases above, outside PHASES' sum: the store's\n"
         '        # pending scan and inventory, the first part of "other", the\n'
         "        # solve's repair and host syncs, and the tick thread's share of\n"
         "        # the mirror (submits, status reads and fetch waits, the sweep\n"
         "        # with the reconciles it settles)\n"
         '        phases["store.pending"] = sched.get("scheduler.store.pending", 0.0)\n'
         '        phases["store.inventory"] = sched.get("scheduler.store.inventory", 0.0)\n'
         '        phases["prepare"] = sched.get("scheduler.prepare", 0.0)\n'
         '        phases["solve.repair"] = sched.get("solve.repair", 0.0)\n'
         '        phases["solve.host_syncs"] = (\n'
         "            float(self.scheduler.last_host_syncs) if self._stack_up else 0.0\n"
         "        )\n"
         '        phases["mirror.submit"] = mirror.get("vnode.submit_chunk", 0.0)\n'
         '        phases["mirror.status"] = mirror.get("vnode.status", 0.0) + mirror.get(\n'
         '            "sim.mirror.fetch_wait", 0.0\n'
         "        )\n"
         '        phases["mirror.sweep"] = mirror.get("operator.sweep", 0.0)\n'),
        # the providers' classification as the mirror's fourth part
        (
            '        # with the reconciles it settles)\n',
            "        # with the reconciles it settles, the providers' classification)\n",
        ),
        (
            '        phases["mirror.sweep"] = mirror.get("operator.sweep", 0.0)\n'
            '\n',
            '        phases["mirror.sweep"] = mirror.get("operator.sweep", 0.0)\n'
            '        phases["mirror.classify"] = mirror.get("vnode.classify", 0.0)\n'
            '\n',
        ),
        # the arrival-time admission as one span, ``sim.arrive.admit``, with
        # its attempts, binds and misses by reason as counters; the tick's
        # admit walls published (the quality tracker's private samples);
        # these and the policy's and the window's spans as parts of the
        # phase dict beside PHASES, outside its sum
        (
            'PHASES = ("arrive", "store", "encode", "solve", "bind", "mirror", "other")\n'
            '\n',
            'PHASES = ("arrive", "store", "encode", "solve", "bind", "mirror", "other")\n'
            '#: counters of the arrival-time admission span ``sim.arrive.admit``: the\n'
            '#: eligible attempts, the fast binds and the misses by reason\n'
            'ADMIT_COUNTS = (\n'
            '    "attempts", "binds", "miss_no_fit", "miss_guard", "miss_not_ready",\n'
            '    "miss_no_window", "miss_conflict", "miss_unknown_partition",\n'
            ')\n'
            '\n',
        ),
        (
            '        self._fast_bound_tick: list[str] = []\n'
            '        self._tick_phases: list[dict[str, float]] = []\n',
            '        self._fast_bound_tick: list[str] = []\n'
            "        #: the tick's arrival-time admission: its span, and the admit walls\n"
            '        #: (ms) of the eligible fast binds after the latency warm-up\n'
            '        self._admit_span = None\n'
            '        self._admit_walls: list[float] = []\n'
            '        self._tick_phases: list[dict[str, float]] = []\n',
        ),
        (
            '            for a in created:\n'
            '                if a.name not in has_sizecar:\n'
            '                    continue\n'
            '                pod_name = f"{a.name}-sizecar"\n'
            '                # the streaming fast path runs AT arrival (event-driven):\n'
            '                # eligible interactive work binds here, in wall-clock\n'
            '                # milliseconds, without waiting for the batch tick\n'
            '                t0 = time.perf_counter()\n'
            '                res = self.scheduler.admit(pod_name)\n'
            '                admit_ms = (time.perf_counter() - t0) * 1e3\n'
            '                if res.eligible and tick >= warmup:\n'
            '                    # the latency axis starts after the cold-start\n'
            '                    # warmup: no window exists before the first solve\n'
            '                    # and no virtual node is ready before the first\n'
            '                    # mirror — steady-state latency is the SLO\n'
            '                    self.quality.note_interactive(a.name)\n'
            '                    if res.bound:\n'
            '                        self.quality.note_fastpath_bind(a.name, admit_ms)\n'
            '                if res.bound:\n'
            '                    self._fast_bound_tick.append(pod_name)\n'
            '                    self.quality.note_bound(a.name, tick)\n'
            '                    self._note(\n'
            '                        tick, "fastbind", pod_name, ",".join(res.hint)\n'
            '                    )\n',
            "            # one span over the tick's admissions: each eligible attempt's\n"
            '            # outcome rides it as a counter (ADMIT_COUNTS)\n'
            '            with TRACER.span("sim.arrive.admit") as admit_span:\n'
            '                self._admit_span = admit_span\n'
            '                for a in created:\n'
            '                    if a.name not in has_sizecar:\n'
            '                        continue\n'
            '                    pod_name = f"{a.name}-sizecar"\n'
            '                    # the streaming fast path runs AT arrival (event-driven):\n'
            '                    # eligible interactive work binds here, in wall-clock\n'
            '                    # milliseconds, without waiting for the batch tick\n'
            '                    t0 = time.perf_counter()\n'
            '                    res = self.scheduler.admit(pod_name)\n'
            '                    admit_ms = (time.perf_counter() - t0) * 1e3\n'
            '                    if res.eligible:\n'
            '                        admit_span.count("attempts")\n'
            '                        admit_span.count(\n'
            '                            "binds" if res.bound else f"miss_{res.reason}"\n'
            '                        )\n'
            '                    if res.eligible and tick >= warmup:\n'
            '                        # the latency axis starts after the cold-start\n'
            '                        # warmup: no window exists before the first solve\n'
            '                        # and no virtual node is ready before the first\n'
            '                        # mirror — steady-state latency is the SLO\n'
            '                        self.quality.note_interactive(a.name)\n'
            '                        if res.bound:\n'
            '                            self.quality.note_fastpath_bind(a.name, admit_ms)\n'
            '                            self._admit_walls.append(admit_ms)\n'
            '                    if res.bound:\n'
            '                        self._fast_bound_tick.append(pod_name)\n'
            '                        self.quality.note_bound(a.name, tick)\n'
            '                        self._note(\n'
            '                            tick, "fastbind", pod_name, ",".join(res.hint)\n'
            '                        )\n',
        ),
        (
            '        self._fast_bound_tick = []\n'
            '        with TRACER.span("sim.arrive") as arrive_span:\n',
            '        self._fast_bound_tick = []\n'
            '        self._admit_span = None\n'
            '        self._admit_walls = []\n'
            '        with TRACER.span("sim.arrive") as arrive_span:\n',
        ),
        (
            '        phases["mirror.classify"] = mirror.get("vnode.classify", 0.0)\n'
            '\n',
            '        phases["mirror.classify"] = mirror.get("vnode.classify", 0.0)\n'
            '        # the arrival-time admission, a part of "arrive": its span, its\n'
            "        # counters, and the tick's published admit walls (ms, the eligible\n"
            "        # fast binds after the latency warm-up, one list); the policy's\n"
            '        # class order (in "prepare"), its backfill (in "other") and the\n'
            '        # fast path\'s window install (in "bind")\n'
            '        admit = self._admit_span\n'
            '        counts = admit.counters if admit is not None else {}\n'
            '        phases["arrive.admit"] = (\n'
            '            admit.duration * 1e3 if admit is not None else 0.0\n'
            '        )\n'
            '        for key in ADMIT_COUNTS:\n'
            '            phases[f"arrive.admit.{key}"] = counts.get(key, 0.0)\n'
            '        phases["arrive.admit.walls"] = self._admit_walls\n'
            '        phases["policy.prepare"] = sched.get("policy.prepare", 0.0)\n'
            '        phases["policy.backfill"] = sched.get("policy.backfill", 0.0)\n'
            '        phases["admission.window"] = sched.get("admission.window", 0.0)\n'
            '\n',
        ),
    ],
    "sim/scenarios.py": [],
    "sim/cli.py": [],
    "sim/__init__.py": [],
    "sim/__main__.py": [],
    # ---- durability and the sharded tick ----
    "utils/wal.py": [],
    "utils/files.py": [],
    "bridge/persist.py": [],
    "bridge/leader.py": [],
    "agent/journal.py": [],
    "agent/cli.py": [],
    "shard/reconcile.py": [],
    "shard/__init__.py": [],
    # each shard's auction, and the multi-device sweep, run on the
    # executor's device; a device failure propagates (no CPU fallback)
    "shard/executor.py": [
        ("   and PROMOTES big shards to the multi-device shard_map sweep\n"
         "   (``solver/sharded.py`` — the MULTICHIP_r05 dp4×mp2 parity dryrun,\n"
         "   now on the routed path) with a CPU fallback to the native packer if\n"
         "   the device solve is unavailable or raises;\n",
         "   and runs the device auction on the executor's ``device`` — the card,\n"
         "   unless asked for the CPU — and PROMOTES big shards to the multi-device\n"
         "   sweep (``solver/sharded.py``) when the process solves on two or more\n"
         "   devices; with fewer they stay on the single-device auction, and a\n"
         "   device failure propagates instead of turning into a CPU solve;\n"),
        ("        bucket: int = 1024,\n", "        bucket: int = 1024,\n        device=None,\n"),
        ("        self.bucket = bucket\n",
         "        self.bucket = bucket\n"
         "        #: where each shard's device auction runs: None is the card (or\n"
         '        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)\n'
         "        self.device = device\n"),
        ("        # collectives rides the shard_map sweep whenever ≥2 devices\n"
         "        # exist (MULTICHIP_r05: dp4×mp2 parity ≥90% vs single-device);\n"
         "        # anything that goes wrong degrades to the native packer — the\n"
         "        # CPU fallback that keeps a device-less (or wedged-chip) host\n"
         "        # solving every tick\n",
         "        # collectives rides the multi-device sweep whenever ≥2 devices\n"
         "        # exist; with fewer it stays on the single-device auction below\n"),
        ('        if self.backend == "auto":\n            route = choose_path(\n'
         "                batch.num_shards,\n                snapshot.num_nodes,\n",
         '        if self.backend == "auto":\n'
         "            from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n\n"
         "            route = choose_path(\n"
         "                batch.num_shards,\n                snapshot.num_nodes,\n"
         "                backend_name=ensure_backend(self.device),\n"),
        ("                st.solver = DeviceSolver(snapshot, self.auction_config)\n",
         "                st.solver = DeviceSolver(\n"
         "                    snapshot, self.auction_config, device=self.device\n"
         "                )\n"),
        ('''        """The shard_map sweep, or None (→ native fallback). Import and
        device probing both live inside the guard: a host without JAX
        devices must not pay (or crash on) backend init per tick."""
        try:
            from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

            ensure_backend()
            import jax

            if len(jax.devices()) < 2:
                return None
            from slurm_bridge_tpu_torch.solver.sharded import sharded_place
''',
         '''        """The multi-device sweep, or None (→ the single-device auction)
        when the process solves on fewer than two devices. Nothing here
        turns a device failure into a CPU solve: it propagates."""
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
        from slurm_bridge_tpu_torch.parallel.mesh import device_count

        if device_count(ensure_backend(self.device)) < 2:
            return None
        from slurm_bridge_tpu_torch.solver.sharded import sharded_place
'''),
        # no try/except: the body moves out one level
        ('''            p_real = batch.num_shards
            inc = incumbent
            if self.bucket:
                batch = pad_batch(batch, self.bucket)
                if batch.num_shards != p_real:
                    inc = np.concatenate(
                        [inc, np.full(batch.num_shards - p_real, -1, np.int32)]
                    )
            with self._device_lock:
                placement = sharded_place(
                    snapshot, batch, self.auction_config, incumbent=inc
                )
            if placement.node_of.shape[0] != p_real:
                placement = Placement(
                    node_of=placement.node_of[:p_real],
                    placed=placement.placed[:p_real],
                    free_after=placement.free_after,
                )
            return placement
        except Exception:
            # wedged chip / missing mesh / OOM: the tick must still
            # solve — log once per occurrence and take the CPU path
            log.warning(
                "device shard_map solve failed%s; falling back to the "
                "native packer for this shard",
                " (forced)" if forced else "",
                exc_info=True,
            )
            return None
''',
         '''        p_real = batch.num_shards
        inc = incumbent
        if self.bucket:
            batch = pad_batch(batch, self.bucket)
            if batch.num_shards != p_real:
                inc = np.concatenate(
                    [inc, np.full(batch.num_shards - p_real, -1, np.int32)]
                )
        with self._device_lock:
            placement = sharded_place(
                snapshot, batch, self.auction_config, incumbent=inc,
                device=self.device,
            )
        if placement.node_of.shape[0] != p_real:
            placement = Placement(
                node_of=placement.node_of[:p_real],
                placed=placement.placed[:p_real],
                free_after=placement.free_after,
            )
        return placement
'''),
    ],
    # ---- the solver's remaining entry points: the obs modules the
    # sidecar and the fleet start, and the fleet itself ----
    "obs/__init__.py": [],
    "obs/logging.py": [],
    # the reference's source tree, named without the absolute path the
    # reference's docstring gives it
    "obs/profiling.py": [
        ("side-effect import (" + "/".join(("", "root", "reference", "cmd", "")),
         "side-effect import (the reference's cmd/"),
    ],
    "obs/otlp.py": [],
    "obs/bootstrap.py": [],
    "fleet/__init__.py": [],
    "fleet/membership.py": [],
    "fleet/columnar.py": [
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import messages as pb\n"),
    ],
    "fleet/worker.py": [
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import messages as pb\n"),
    ],
    "fleet/runtime.py": [
        ("        from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "        from slurm_bridge_tpu_torch.wire import messages as pb\n"),
    ],
    # the worker's engines are the host packers: it is spawned on the CPU
    # backend, which it never leaves
    "fleet/sidecar.py": [
        ("        from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "        from slurm_bridge_tpu_torch.wire import messages as pb\n"),
        ('        env = {**os.environ, "JAX_PLATFORMS": "cpu"}\n',
         '        env = {**os.environ, "SBT_BACKEND": "cpu"}\n'),
    ],
    # ---- the bridge's daemons: the agent server, the Bridge runtime, the
    # result fetcher, the kube API client, the kubelet HTTP server and
    # their utilities ----
    "utils/fs.py": [],
    "utils/inotify.py": [],
    "utils/tail.py": [],
    "utils/flags.py": [],
    # cryptography stays imported where a certificate is made
    "utils/certs.py": [],
    # no yaml on the card's machine: imported where a config is read or
    # written
    "utils/codec.py": [
        ("import typing\n\nimport yaml\n\n", "import typing\n\n"),
        ('    """YAML → dataclass, strict first, lenient on unknown-field failure."""\n'
         "    raw = yaml",
         '    """YAML → dataclass, strict first, lenient on unknown-field failure."""\n'
         "    import yaml\n\n    raw = yaml"),
        ("def encode_yaml_config(obj) -> str:\n    return yaml",
         "def encode_yaml_config(obj) -> str:\n    import yaml\n\n    return yaml"),
    ],
    "agent/config.py": [
        ("from __future__ import annotations\n\nimport yaml\n\n",
         "from __future__ import annotations\n\n"),
        ("def parse_partition_config(text: str) -> dict[str, PartitionResources]:\n"
         "    raw = yaml",
         "def parse_partition_config(text: str) -> dict[str, PartitionResources]:\n"
         "    import yaml\n\n    raw = yaml"),
    ],
    "agent/tailer.py": [],
    # no grpc on the card's machine: the servicer aborts with the port's
    # StatusCode (LocalContext raises it in process, the transport turns
    # it into grpc's code of the same name)
    "agent/server.py": [
        ("import uuid\n\nimport grpc\n\n", "import uuid\n\n"),
        ("from slurm_bridge_tpu_torch.wire import pb\n",
         "from slurm_bridge_tpu_torch.wire import StatusCode, pb\n"),
        ("grpc.StatusCode", "StatusCode", 12),
    ],
    "agent/main.py": [],
    "bridge/client.py": [],
    "bridge/kubeapi.py": [
        ("    from slurm_bridge_tpu import __version__\n",
         "    from slurm_bridge_tpu_torch import __version__\n"),
    ],
    "bridge/vkhttp.py": [],
    "bridge/vnconfig.py": [],
    # the port's RpcError, which the transport raises for grpc's
    "bridge/fetcher.py": [
        ("import threading\n\nimport grpc\n\n", "import threading\n\n"),
        ("from slurm_bridge_tpu_torch.wire import ServiceClient, dial, pb\n",
         "from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, dial, pb\n"),
        ("grpc.RpcError", "RpcError", 3),
    ],
    # the device keyword, checked before anything is built, handed to the
    # scheduler
    "bridge/runtime.py": [
        ("from slurm_bridge_tpu_torch.obs.events import EventRecorder\n",
         "from slurm_bridge_tpu_torch.obs.events import EventRecorder\n"
         "from slurm_bridge_tpu_torch.parallel.backend import ensure_backend\n"),
        ("        explain: bool = True,\n    ):\n        self.agent_endpoint = agent_endpoint\n",
         "        explain: bool = True,\n        device=None,\n    ):\n"
         "        #: where the scheduler's device auction runs: None is the card (or\n"
         '        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py); checked\n'
         "        #: before anything is built, so a missing card fails here and not\n"
         "        #: on the scheduler thread's first solve\n"
         "        self.device = device\n"
         "        ensure_backend(device)\n"
         "        self.agent_endpoint = agent_endpoint\n"),
        ("            explain=explain,\n        )\n        self._sched_ticker",
         "            explain=explain,\n            device=device,\n        )\n"
         "        self._sched_ticker"),
    ],
    "bridge/main.py": [],
    "bridge/demo.py": [],
}


@pytest.mark.parametrize("rel", sorted(ALLOWED))
def test_copy_matches_reference(rel):
    ref = (ROOT / "slurm_bridge_tpu" / rel).read_text()
    want = ref.replace("slurm_bridge_tpu.", "slurm_bridge_tpu_torch.")
    for old, new, *times in ALLOWED[rel]:
        n = times[0] if times else 1
        assert want.count(old) == n, f"{rel}: allowed change no longer applies: {old!r}"
        want = want.replace(old, new)
    assert (ROOT / "slurm_bridge_tpu_torch" / rel).read_text() == want


#: (port file, function) → the (reference text, port text) replacements
#: of a function the port copies into a module of its own
ALLOWED_FUNCTIONS = {
    ("parallel/mesh.py", "pad_to_multiple"): [],
    # the rendezvous is torch.distributed's
    ("parallel/distributed.py", "slurm_process_env"): [
        ("which is all ``jax.distributed``\n", "which is all the rendezvous\n"),
    ],
}


def _function_source(path: pathlib.Path, name: str) -> str:
    src = path.read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(src, node)
    raise AssertionError(f"{path}: no function {name}")


@pytest.mark.parametrize("rel,name", sorted(ALLOWED_FUNCTIONS))
def test_copied_function_matches_reference(rel, name):
    want = _function_source(ROOT / "slurm_bridge_tpu" / rel, name)
    want = want.replace("slurm_bridge_tpu.", "slurm_bridge_tpu_torch.")
    for old, new, *times in ALLOWED_FUNCTIONS[(rel, name)]:
        n = times[0] if times else 1
        assert want.count(old) == n, f"{rel}:{name}: allowed change no longer applies: {old!r}"
        want = want.replace(old, new)
    assert _function_source(ROOT / "slurm_bridge_tpu_torch" / rel, name) == want
