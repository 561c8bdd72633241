"""The whole training step's share of the card's bf16 peak over the traced
slice: the model's convolution FLOPs (forward, and twice that for the
backward, of the trained model; the forward of a teacher where there is
one) for every image stepped, over the traced window."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None or not run.extra.get('traced_steps'):
        return None
    models = run.cfg['models']
    per_image = 3 * work.forward_flops(models['train'])
    if 'teacher' in models:
        per_image += work.forward_flops(models['teacher'])
    images = run.extra['traced_steps'] * run.extra['batch_size']
    return 100.0 * per_image * images / t.window_s / work.BF16_FLOP_PER_S
