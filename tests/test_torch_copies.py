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
    "obs/tracing.py": [],
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
    ],
    "policy/classes.py": [],
    "policy/fairshare.py": [],
    "policy/engine.py": [],
    "admission/__init__.py": [],
    "admission/residual.py": [],
    "admission/fastpath.py": [],
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
    "bridge/operator.py": [],
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
    ],
    "bridge/configurator.py": [],
    "obs/flight.py": [],
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
