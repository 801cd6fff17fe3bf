"""The ELL kernels' share of their roofline over the analyst's traced
window: the least time of every ``spmv_ell``/``spmm_ell`` launch (bytes
of the reference's own factor at the card's HBM rate, from
``bench/yardstick/ell_bytes.py``) over the profiler's device time of
those launches.  A call counts only where the profiler recorded its
launch inside the call's interval.  Moves ``requests_per_s``."""


def read(run):
    p, ell = run.profile, run.layer.get("ell")
    if p is None or not ell:
        return None
    need = spent = 0.0
    for w0, w1, kernel, least in ell:
        got = [e - s for s, e in p.kernel_intervals(kernel) if w0 <= s <= w1]
        if got:
            need += least
            spent += sum(got)
    return 100.0 * need / spent if spent > 0 else None
