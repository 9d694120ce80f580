"""The event-driven incremental tick (``tests/test_incremental.py``): off
reproduces the pre-change fixture, on equals off across arrival, drain
and fault shapes, and the dirty-set bookkeeping — run against the port.

One rewrite: the port patches the mirror's working set for a terminal
transition (a leave) where the JAX package reclassifies the node bucket,
so ``test_scoped_mirror_rescan_falls_back_on_membership_change`` holds the
port to no full classification, one patched leave per completed pod, and
the same final phases."""

from test_torch_twins import load_twin

globals().update(load_twin("test_incremental", rewrites=[(
    "    # sync 2: the terminal transitions left the live set — the scoped\n"
    "    # patch refuses (membership change) and the full classification\n"
    "    # runs, exactly the pre-change behavior\n"
    "    p0.sync()\n"
    "    assert p0.mirror_scans_full == full0 + 1\n",
    "    # sync 2: the terminal transitions left the live set — each is a\n"
    "    # patched leave, and the node bucket is not reclassified\n"
    "    leaves0 = p0.mirror_patched_leaves\n"
    "    p0.sync()\n"
    "    assert p0.mirror_scans_full == full0\n"
    "    assert p0.mirror_patched_leaves == leaves0 + len(pods)\n"
    "    assert p0._mirror_cache.rb.names == []\n"
    "    assert len(p0._mirror_cache.ids) == 0\n"
    "    after = [p for p in store.list(Pod.KIND) if p.spec.partition == \"part0\"]\n"
    "    assert [p.name for p in after] == [p.name for p in pods]\n"
    "    assert all(p.status.phase == PodPhase.SUCCEEDED for p in after)\n",
)]))
