"""policy_prepare_ms: the policy's pass over the pending set (the
`policy.prepare` span inside "prepare": class order, fair share and the
preemption pool, with counters `pending` and `deferred`), window mean per
tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "policy.prepare")
