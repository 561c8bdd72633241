"""The stem kernel's share of its roofline over the traced slice of
serving: every launch of `stem_conv_kernel` is one served batch's stem
(work.stem_work at the server's batch, bf16), over their traced time."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None:
        return None
    launches = t.count('stem_conv_kernel')
    spent = t.kernel_s('stem_conv_kernel')
    if not launches or spent <= 0:
        return None
    m = run.cfg['models']['serve']
    s = m['side']
    bound = work.bound_s(*work.stem_work(run.extra['batch_size'],
                                         m['in_channels'], s, s, 2),
                         flop_rate=work.BF16_FLOP_PER_S)
    return 100.0 * bound * launches / spent
