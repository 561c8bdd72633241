"""The stem kernel's share of its roofline over the traced slice: the
teacher's bf16 forward launches it on the colour (Cin 3) and depth (Cin
1) stems each step; work.stem_work from those shapes over the traced time
of `stem_conv_kernel`. A step that launches no stem kernel reads
nothing."""

from port_bench import work


def read(run):
    t = run.trace_result
    if t is None or not run.extra.get('traced_steps'):
        return None
    spent = t.kernel_s('stem_conv_kernel')
    teacher = run.cfg['models'].get('teacher')
    if spent <= 0 or teacher is None:
        return None
    b, s = run.extra['batch_size'], teacher['side']
    bound = sum(work.bound_s(*work.stem_work(b, cin, s, s, 2),
                             flop_rate=work.BF16_FLOP_PER_S)
                for cin in (teacher['in_channels'], 1))
    return 100.0 * bound * run.extra['traced_steps'] / spent
