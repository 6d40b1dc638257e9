"""pm_match.roofline_pct.farm: the PatchMatch match kernel (``stereo/
patchmatch.py`` -> ``csrc/patchmatch.cu``, one launch a side for every
camera) against its roofline on the first profiled call's inputs.

Bytes (frozen from the repository's smoke test, ``match_bound``): the seeds
and the noise read once and the disparities written once; of the volume,
each element that the plain match reads on these inputs, once, however many
of its 12 passes read it (``VolumeReads`` over the reference's match on
the same volume, seed and noise, and cost(0) of every pixel for the mask).
The entry records each camera's volume, seed and noise, and the
reference's match, from the reference's run of that call
(``roofline_calls``); its device time is that call's launch."""

import re

import torch

from perfbench.harness.peaks import bound_us, kernel_us

KERNEL = re.compile(r"pm_match_kernel")


class VolumeReads(torch.overrides.TorchFunctionMode):
    """Records which elements of the volumes a plain match reads: the
    storage offsets of every advanced index (``vol[cam, a, b, d]``) into a
    view of one of vols and of every ``torch.gather`` from one, each
    volume's offsets apart. A pass's reads where its loop bounds fail (the
    1-px frame, the last row or column of a scan) decide nothing and are
    left out; so are basic indices (the mask's cost(0), added by the
    caller)."""

    def __init__(self, vols, pr: int):
        super().__init__()
        self.vols = {v.data_ptr(): i for i, v in enumerate(vols)}
        self.pr = pr
        self.offsets = [[] for _ in vols]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = args[0] if args else None
        k = self.vols.get(src.data_ptr()) if isinstance(src, torch.Tensor) else None
        if k is not None and func is torch.Tensor.__getitem__ and isinstance(args[1], tuple) \
                and all(isinstance(i, torch.Tensor) for i in args[1]):
            index = torch.broadcast_tensors(*args[1])
            a, b = index[-3], index[-2]
            n, lanes, pr = src.shape[-3], src.shape[-2], self.pr
            used = (a >= pr) & (a <= n - pr - 2) & (b >= pr) & (b <= lanes - pr - 1)
            off = sum(i * st for i, st in zip(index, src.stride()))
            self.offsets[k].append(off[used])
        elif k is not None and func is torch.gather:
            assert args[1] in (-1, src.dim() - 1), "a gather along the disparity axis"
            index = args[2]
            grid = torch.meshgrid(*(torch.arange(m, device=index.device)
                                    for m in index.shape[:-1]), indexing="ij")
            off = sum(g[..., None] * st for g, st in zip(grid, src.stride())) \
                + index * src.stride(-1)
            self.offsets[k].append(off.flatten())
        return func(*args, **kwargs)


def match_bytes(C, seed, noise, match) -> int:
    """Bytes one camera's share of a match launch must move: C (H, W, D),
    ``match`` the reference's match of a batch of volumes."""
    H, W, D = C.shape[-3:]
    reads = VolumeReads([C], 1)
    with reads:
        match(C[None], seed[None], noise)
    yy, xx = torch.meshgrid(torch.arange(H, device=C.device), torch.arange(W, device=C.device),
                            indexing="ij")
    reads.offsets[0].append((yy * C.stride(-3) + xx * C.stride(-2)).flatten())
    elements = int(torch.unique(torch.cat(reads.offsets[0])).numel())
    return H * W * (4 + 4) + elements * C.element_size()


def read(rec):
    s, calls = rec.stretch, rec.data.get("roofline_calls", {}).get("pm_match")
    if s is None or not calls:
        return None
    (device_us,) = kernel_us([s.kernels_in(s.units[0])], KERNEL)
    if device_us <= 0:
        return None
    H, W = calls[0][0].shape[-3:-1]
    nbytes = H * W * 4 + sum(match_bytes(*c) for c in calls)  # the noise once a launch
    return 100.0 * bound_us(nbytes) / device_us
