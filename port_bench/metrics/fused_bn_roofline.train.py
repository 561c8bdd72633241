"""The fused-BN kernels' share of their roofline over the traced slice:
the least time of every launch a step makes (the trained model's BN
layers forward and backward, a teacher's forward only), from
work.bn_work on the layers' shapes with bf16 activations, over the traced
time of every `fbn_` kernel."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None or not run.extra.get('traced_steps'):
        return None
    spent = t.kernel_s('fbn_')
    if spent <= 0:
        return None
    b, models = run.extra['batch_size'], run.cfg['models']
    bound = work.bn_bound_s(work.model_layers(models['train'])[1], b, 2,
                            backward=True)
    if 'teacher' in models:
        bound += work.bn_bound_s(work.model_layers(models['teacher'])[1], b,
                                 2, backward=False)
    return 100.0 * bound * run.extra['traced_steps'] / spent
