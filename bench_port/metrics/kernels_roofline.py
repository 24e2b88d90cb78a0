"""kernels_roofline (%): over every launch of the port's hand-written
kernels inside the traced window, the sum of each launch's least time
over the sum of their device times. A launch's least time is the larger
of its bytes over the card's memory rate and its operations over the
card's peak for their type (bench_port/kernels/_roofline.py), both
counted from the cell's shapes by the kernel's own file in
bench_port/kernels. Dependent-chain floors are not charged. Launches of
no counted kernel (torch's own, copies) are left out. Device trace."""


def read(run):
    from bench_port.kernels import _roofline
    t = run.trace
    if t is None:
        return None
    least, dur, per = _roofline.tally(t.kernels(), run.kernel_counts,
                                      run.shapes)
    for name, (n, lt, d) in sorted(per.items()):
        run.log(f"roofline {name}: {n} launches, {d / n * 1e3:.4f} ms "
                f"a launch, least {lt / n * 1e3:.5f} ms "
                f"({100 * lt / d:.1f} %)")
    if dur <= 0:
        return None
    return 100.0 * least / dur
