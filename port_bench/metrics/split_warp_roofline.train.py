"""The split warp kernel's share of its roofline over the traced slice:
work.split_warp_work on each traced batch's own canvases, homographies
and extents (the colour stream, and the depth stream where there is one),
over the traced time of `split_warp_kernel`."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None or not run.extra.get('traced_items'):
        return None
    spent = t.kernel_s('split_warp_kernel')
    if spent <= 0:
        return None
    side = run.cfg['models']['train']['side']
    bound = 0.0
    for it in run.extra['traced_items']:
        bound += work.split_warp_bound_s(it['canvases'], it['homs'],
                                         it['extents'], side)
        if 'depth_canvases' in it:
            bound += work.split_warp_bound_s(
                it['depth_canvases'], it['depth_homs'], it['depth_extents'],
                side)
    return 100.0 * bound / spent
