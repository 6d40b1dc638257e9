"""lk_track.roofline_pct.farm: the LK kernel (``tracking/lk.py`` ->
``csrc/lk.cu``, every level of one direction a launch, every camera folded
in; 2 launches a call) against its roofline on the first profiled call.

Bytes and operations (frozen from the repository's smoke test,
``lk_bounds``): each point's template and slack windows a level read, its
point, guess and frame indices read, its point and status written; the
two-tap recentring, the gradients, the 5 window sums, the 2*A*A surface
sums of win^2 multiply-adds and the walk's steps, each step as the
reference's walk took it on these inputs. Each camera's two directions come
from the reference's run of that call (``roofline_calls``); the two
launches' bounds add, over their device time in that call."""

import re

from perfbench.harness.peaks import bound_us, kernel_us

KERNEL = re.compile(r"lk_track_kernel")
SLACK = 4   # the walk's slack window, as the reference's tracker walks


def lk_work(K: int, levels, slack: int = SLACK) -> tuple:
    """(bytes, operations) of one direction of K points: levels holds a
    (level, window, steps moved by all points) a level walked."""
    nbytes, flops = K * (4 * 2 * 2 + 4 * 2 + 4 * 2 + 1), 0
    for _, win, steps in levels:
        ST, P, ws = win + 3, win + 2, win + 2 * (slack + 1)
        A = ws - win + 1
        tmpl_flops = 3 * P * ST + 3 * P * P + 4 * win * win + 5 * 2 * win * win
        nbytes += K * 4 * (ST * ST + ws * ws)
        flops += K * (tmpl_flops + 2 * A * A * 2 * win * win + 20)
        flops += int(steps) * 50  # a step's tents, lookups, solve and test
    return nbytes, flops


def read(rec):
    s, calls = rec.stretch, rec.data.get("roofline_calls", {}).get("lk_track")
    if s is None or not calls:
        return None
    (device_us,) = kernel_us([s.kernels_in(s.units[0])], KERNEL)
    if device_us <= 0:
        return None
    # calls: per camera, the call's directions in order; direction j of
    # every camera is one folded launch of the program's.
    total = 0.0
    for launch in zip(*calls):
        work = [lk_work(K, levels) for K, levels in launch]
        total += bound_us(sum(b for b, _ in work), sum(f for _, f in work))
    return 100.0 * total / device_us
