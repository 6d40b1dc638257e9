"""One frame's PatchMatch across several devices: each owns a block of rows
(port of ``ocean_perception_tpu.parallel.stereo_sharded``).

A frame of H rows is split into N blocks of H/N rows, block i on mesh entry
i, and each block is one y-strip of the single-device engine with
``chunks_y = N`` (``stereo/patchmatch.py``): the result equals that
engine's bit for bit, every row included.

Communication, nearest neighbour only, each a copy of a neighbour's
boundary rows to this block's device:
  - once a frame, R_img = max(halo, seed reach) + 2 image rows each way, so
    the block computes its volume, seed and gradients itself;
  - before each column pass (2 an iteration), halo + 1 rows of the
    (disparity, cost) fronts: the column scan's warm-up positions and the
    predecessor of its first position.
Row passes, the right WTA, the subpixel refinement and the occlusion mask
are row-local.

Each block's work runs in order on its entry's :class:`~.mesh.Queue` (a
CUDA stream, or a worker thread on the CPU). A block posts views of its
boundary rows after a pass and records an event; its neighbours wait for
that event before they copy the rows, so a copy never reads rows that a
pass has not finished writing, and the posted tensors are never written
again (every pass writes new ones).

Each pass is one launch of ``pm_pass`` (``csrc/patchmatch.cu``), the
refresh folded into R+ and MaskBackground into the last C-: 4 * iters
launches a block a frame, and one ``cost_volume`` launch a block.

The frame's border. Reflect-101 ghost rows (a border block mirrors its own
rows) give the Sobel gradients their global padding; the cost stencil
instead edge-pads, so before the volume is built the rows past the frame's
edge take the edge row, of the image and of its gradient alike, and so do
the confident-WTA rows the seed's dilation reads there. Each is then what
the whole frame's functions pad with, and no splice of border rows is
needed.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import torch

from ..ops.image import dilate, gradient_magnitude
from ..stereo.cost import cost_volume
from ..stereo.patchmatch import (BlockRows, PatchMatchParams, PatchMatchResult, _refine,
                                 block_pass, confident_wta, mask_occlusions,
                                 right_wta_from_left, seed_reach, unit_noise)
from .mesh import Mesh, join_rows, queues, split_rows


def _reaches(p: PatchMatchParams):
    """(R_C, R_img): volume rows a block needs past its own (column warm-up
    and seed dilation), and image rows (+ gradient and stencil reach)."""
    R_C = max(p.halo, seed_reach(p))
    return R_C, R_C + 2


def check_strip(chunk: int, p: PatchMatchParams) -> None:
    """A border block mirrors rows 1..R_img of its own, so it needs R_img + 1."""
    need = max(_reaches(p)[1] + 1, p.halo + 1)
    if chunk < need:
        raise ValueError(f"strip of {chunk} rows too thin for halo exchange "
                         f"(needs >= {need}); use fewer devices or taller images")


@functools.lru_cache(maxsize=64)
def _frame_rows(first: int, count: int, H: int, device: torch.device):
    """Local index of each of frame rows first .. first+count-1 with rows past
    the frame's edge taken from the edge row; None if none is past it."""
    if first >= 0 and first + count <= H:
        return None
    return torch.arange(first, first + count, device=device).clamp(0, H - 1) - first


def _edge_rows(x: torch.Tensor, first: int, H: int) -> torch.Tensor:
    """Rows of x (frame rows first on) past the frame's edge replaced by the edge row."""
    rows = _frame_rows(first, x.shape[0], H, x.device)
    return x if rows is None else x.index_select(0, rows)


class _Exchange:
    """Boundary rows posted by each block for a round, read by its
    neighbours after the round's events."""

    def __init__(self, qs):
        self.qs = qs
        self.posts: Dict[tuple, tuple] = {}

    def post(self, tag: str, i: int, k: int, *xs: torch.Tensor) -> None:
        self.posts[tag, i] = tuple((x[:k], x[-k:]) for x in xs)

    def order(self) -> None:
        """Each queue waits for its neighbours' posts of this round."""
        events = [q.record() for q in self.qs]
        for i, q in enumerate(self.qs):
            for j in (i - 1, i + 1):
                if 0 <= j < len(self.qs):
                    q.wait(events[j])

    def ghosts(self, tag: str, i: int, which: int, own: torch.Tensor, k: int, reflect: bool):
        """(top, bottom): the k frame rows above and below block i's own
        rows ``own``. Past the frame's edge: own rows 1..k mirrored
        (reflect-101) or the edge row repeated."""
        q, n = self.qs[i], len(self.qs)
        out = []
        for j, side, mirror, edge in ((i - 1, 1, lambda: own[1:k + 1].flip(0), own[:1]),
                                      (i + 1, 0, lambda: own[-k - 1:-1].flip(0), own[-1:])):
            if 0 <= j < n:
                rows = q.use(self.posts[tag, j][which][side])
                out.append(rows.to(own.device))
            else:
                out.append(mirror() if reflect else edge.expand(k, *own.shape[1:]))
        return out


def patchmatch_blocks(gl_blocks: Sequence[torch.Tensor], gr_blocks: Sequence[torch.Tensor],
                      p: PatchMatchParams) -> List[PatchMatchResult]:
    """The match of a frame whose rows are split into equal blocks, block i
    a (chunk, W) float32 gray pair on its device: one
    :class:`PatchMatchResult` of (chunk, W) maps a block, on its device."""
    if not p.right_wta:
        raise ValueError("sharded_patchmatch supports the right_wta operating point")
    if p.cost != "l1g" or p.use_strip_volumes or p.iters < 1:
        raise ValueError(f"sharded_patchmatch matches the l1g cost over the (H, W, D) volume "
                         f"with iters >= 1, got cost={p.cost!r}, use_strip_volumes="
                         f"{p.use_strip_volumes}, iters={p.iters}")
    n = len(gl_blocks)
    chunk, W = gl_blocks[0].shape
    H = n * chunk
    check_strip(chunk, p)
    R_C, R_img = _reaches(p)
    k = p.halo + 1
    vdtype = torch.bfloat16 if p.volume_bf16 else torch.float32
    st = [dict(gl=l, gr=r, row0=i * chunk) for i, (l, r) in enumerate(zip(gl_blocks, gr_blocks))]

    with queues([b.device for b in gl_blocks]) as qs:
        ex = _Exchange(qs)

        def volume(i: int) -> None:
            s = st[i]
            row0, dev = s["row0"], s["gl"].device
            inputs = []
            for name in ("gl", "gr"):
                top, bot = ex.ghosts("img", i, 0 if name == "gl" else 1, s[name], R_img, True)
                x = torch.cat([top, s[name], bot])  # frame rows row0 - R_img on
                g = gradient_magnitude(x)[1:-1]
                first = row0 - R_C - 1
                inputs += [_edge_rows(x[1:-1], first, H), _edge_rows(g, first, H)]
            iml, gl, imr, gr = inputs
            C_ext = cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, dtype=vdtype)[1:-1]
            wta = _edge_rows(confident_wta(C_ext, p), row0 - R_C, H)
            seed = dilate(wta, 2 * seed_reach(p) + 1)[R_C:R_C + chunk]
            s.update(C_ext=C_ext, C=C_ext[R_C:R_C + chunk], disp=seed.float(), cost=None,
                     noise=unit_noise((H, W), p.noise_seed, dev, row0, chunk),
                     block=BlockRows(row0, chunk, H, row0 - R_C, row0))

        def row_pass(i: int, direction: int, refresh: bool, scale: float, tag: str) -> None:
            s = st[i]
            s["disp"], s["cost"] = block_pass(s["C_ext"], s["disp"], s["cost"], s["noise"],
                                              direction, 1, refresh, s["block"], p, scale)
            ex.post(tag, i, k, s["disp"], s["cost"])

        def col_pass(i: int, direction: int, mask: bool, tag: str) -> None:
            s = st[i]
            td, bd = ex.ghosts(tag, i, 0, s["disp"], k, False)
            tc, bc = ex.ghosts(tag, i, 1, s["cost"], k, False)
            disp = torch.cat([td, s["disp"], bd])  # frame rows row0 - k on
            cost = torch.cat([tc, s["cost"], bc])
            s["disp"], s["cost"] = block_pass(s["C_ext"], disp, cost, None, direction, 0, mask,
                                              s["block"]._replace(front_row0=s["row0"] - k), p)

        def finish(i: int) -> None:
            s = st[i]
            C, disp_l = s["C"], s["disp"]
            disp_r = right_wta_from_left(C, p)
            if p.subpixel:
                disp_l = _refine(C, disp_l, p)
            s["result"] = PatchMatchResult(mask_occlusions(disp_l, disp_r, p), disp_r, disp_l)
            st[i] = {"result": s["result"]}  # drop the volume

        def run(stage: str, fn, *args) -> None:
            """fn(i, *args) on every block's queue, its work named in a trace.
            A CPU queue runs it later: the arguments are bound now."""
            for i, q in enumerate(qs):
                q.run(functools.partial(fn, i, *args), f"block {i} {stage}")

        run("post image rows", lambda i: ex.post("img", i, R_img, st[i]["gl"], st[i]["gr"]))
        ex.order()
        run("volume and seed", volume)
        for it in range(p.iters):
            scale = p.noise_scale0 / 2.0**it
            for direction in (+1, -1):
                tag = f"{it}{direction:+d}"
                mask = direction < 0 and it == p.iters - 1
                run(f"row pass {tag}", row_pass, direction, direction > 0, scale, tag)
                ex.order()
                run(f"column pass {tag}", col_pass, direction, mask, tag)
        run("finish", finish)
    return [s["result"] for s in st]


def sharded_patchmatch(gray_l: torch.Tensor, gray_r: torch.Tensor, mesh: Mesh,
                       params: PatchMatchParams = PatchMatchParams(right_wta=True),
                       axis: str = "strip") -> PatchMatchResult:
    """Dense PatchMatch disparity for ONE (H, W) stereo pair with its rows
    split over ``mesh[axis]``; see the module docstring. Requires
    ``params.right_wta`` (the production operating point). Returns the
    whole maps on the axis's first device.

    Single-device equivalent, bit for bit: ``patchmatch_disparity(...,
    replace(params, chunks_y=mesh.shape[axis]))``."""
    devices = mesh.axis_devices(axis)
    H, n = gray_l.shape[0], len(devices)
    if H % n != 0:
        raise ValueError(f"H={H} must divide evenly over {n} devices")
    results = patchmatch_blocks(split_rows(torch.as_tensor(gray_l).float(), devices),
                                split_rows(torch.as_tensor(gray_r).float(), devices), params)
    return PatchMatchResult(*(join_rows(maps, devices[0]) for maps in zip(*results)))
