"""The served forward's share of the card's bf16 peak over the traced
slice: the model's convolution FLOPs of every crop served (padding rows
not counted), over the traced window."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None or not run.extra.get('traced_crops'):
        return None
    flops = work.forward_flops(run.cfg['models']['serve'])
    return (100.0 * flops * run.extra['traced_crops'] / t.window_s
            / work.BF16_FLOP_PER_S)
