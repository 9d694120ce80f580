"""mirror_classify_ms: the providers' classification of the mirror's
working set (`vnode.classify`: the dirty-set probe, the patch of the kept
working set or the full scan of the node bucket, the cache update; not the
submits), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "mirror.classify")
