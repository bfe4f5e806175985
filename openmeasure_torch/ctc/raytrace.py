"""Voxel ray traversal (Amanatides–Woo DDA) and the device-side assembly of
the binary projection operator (port of ``openmeasure_tpu/ctc/raytrace.py``).

:func:`trace_rays` walks every segment of a bundle through the grid at
once: the per-ray state is a few ``(n_rays, 3)`` tensors, and the loop
runs exactly ``nx + ny + nz + 3`` steps with no early exit and
no read back to the host, as the JAX package's ``fori_loop`` does.  A ray
records the voxel it stands in while it is active and inside the grid, then
steps along the axis whose next boundary crossing comes first (the lowest
axis on a tie) and stops once that crossing lies past the segment's end.

The cells must equal the JAX package's bit for bit, so the floating-point
operations keep its order: the slab clip, the entry point
``p1 + (t0 + eps)·d``, the first crossings, and the per-step accumulation
``t_max += t_delta``.  Each is a separate elementwise operation (no fused
multiply-add, no ``addcmul``), so the CPU and the card round alike.

:func:`trace_csr_device` turns the traced cells into the operator's CSR
skeleton on the device: composite ``pixel·n_cells + cell`` keys (int32, a
sentinel of 2³¹−1 for the padding), one sort, a first-occurrence mask, a
second sort cut to a static budget ``out_cap``, and per-pixel counts by a
scatter-add into ``n_pixels + 1`` bins whose last one (the padding's) is
dropped.  Nothing in it reads back to the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# int32 max: sorts after every valid composite key (valid keys are
# < n_pixels·n_cells < 2^31, which the caller guarantees)
_KEY_SENTINEL = 2147483647


def trace_rays(p1s: torch.Tensor, p2s: torch.Tensor, origin, spacing,
               dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traverse the segments ``p1s[i] → p2s[i]`` (each ``(n_rays, 3)``, one
    floating dtype, one device) through the voxel grid ``(origin,
    spacing, dims)``.

    Returns ``(cells (n_rays, nx+ny+nz+3) int32 padded with −1, counts
    (n_rays,) int32)``; cells are VTK linear indices ``i + nx·(j + ny·k)``
    in the order the segment enters them."""
    dt, dev = p1s.dtype, p1s.device
    org = torch.as_tensor(origin, dtype=dt, device=dev)
    spc = torch.as_tensor(spacing, dtype=dt, device=dev)
    nd = torch.as_tensor(tuple(dims), dtype=torch.int32, device=dev)
    nx, ny, nz = (int(d) for d in dims)
    max_steps = nx + ny + nz + 3
    big = torch.full((), float("inf"), dtype=dt, device=dev)
    eps = float(torch.finfo(dt).eps) * 16

    lo = org
    hi = org + spc * torch.as_tensor(tuple(dims), dtype=dt, device=dev)

    d = p2s - p1s
    # slab clip to the grid's box, degenerate axes handled explicitly
    degenerate = torch.abs(d) < 1e-30
    safe_d = torch.where(degenerate, torch.ones((), dtype=dt, device=dev), d)
    t_lo = (lo - p1s) / safe_d
    t_hi = (hi - p1s) / safe_d
    inside = (p1s >= lo) & (p1s <= hi)
    inf_in = torch.where(inside, -big, big)
    t_near = torch.where(degenerate, inf_in, torch.minimum(t_lo, t_hi))
    t_far = torch.where(degenerate, -inf_in, torch.maximum(t_lo, t_hi))
    t0 = torch.clamp(torch.amax(t_near, dim=1), min=0.0)
    t1 = torch.clamp(torch.amin(t_far, dim=1), max=1.0)
    hit = t0 <= t1

    # entry voxel
    pe = p1s + (t0 + eps)[:, None] * d
    vox = torch.floor((pe - org) / spc).to(torch.int32)
    vox = torch.minimum(torch.clamp(vox, min=0), nd - 1)

    step = (d > 0).to(torch.int32) - (d < 0).to(torch.int32)
    t_delta = torch.where(degenerate, big, torch.abs(spc / safe_d))
    # parameter t of the first boundary crossing on each axis
    next_bound = org + (vox + (step > 0).to(torch.int32)) * spc
    t_max = torch.where(degenerate | (step == 0), big,
                        (next_bound - p1s) / safe_d)

    # the per-axis state as (n_rays, 3) tensors: one launch updates all
    # three axes, and each element takes exactly JAX's operations
    strides = torch.as_tensor((1, nx, nx * ny), dtype=torch.int32,
                              device=dev)
    t_stop = t1 + eps
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_t = torch.zeros((), dtype=dt, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    tmx, tmy, tmz = t_max[:, 0], t_max[:, 1], t_max[:, 2]

    active = hit
    cols = []
    for _ in range(max_steps):
        lin = torch.sum(vox * strides, dim=1, dtype=torch.int32)
        in_bounds = torch.all((vox >= 0) & (vox < nd), dim=1)
        record = active & in_bounds
        cols.append(torch.where(record, lin, minus1))

        # argmin over (tmx, tmy, tmz), the first axis on a tie
        ax0 = (tmx <= tmy) & (tmx <= tmz)
        ax1 = ~ax0 & (tmy <= tmz)
        ax2 = ~(ax0 | ax1)
        # the chosen crossing is the smallest of the three
        t_next = torch.amin(t_max, dim=1)
        # stop after recording when the next crossing leaves the segment
        active = record & (t_next <= t_stop)
        axis = torch.stack([ax0, ax1, ax2], dim=1)
        vox = vox + torch.where(axis, step, zero_i)
        t_max = t_max + torch.where(axis, t_delta, zero_t)
        tmx, tmy, tmz = t_max[:, 0], t_max[:, 1], t_max[:, 2]
    cells = torch.stack(cols, dim=1)
    # a ray records one cell a step while it is active
    return cells, torch.sum(cells >= 0, dim=1, dtype=torch.int32)


def trace_csr_device(p1s: torch.Tensor, p2s: torch.Tensor, origin, spacing,
                     dims: Sequence[int], pix: torch.Tensor, n_cells: int,
                     n_pixels: int, out_cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trace and assemble the binary operator's CSR skeleton on the device:
    :func:`trace_rays`, then :func:`csr_from_cells`.  The caller guarantees
    ``n_pixels·n_cells < 2³¹``."""
    cells, _ = trace_rays(p1s, p2s, origin, spacing, dims)
    return csr_from_cells(cells, pix, n_cells, n_pixels, out_cap)


def csr_from_cells(cells: torch.Tensor, pix: torch.Tensor, n_cells: int,
                   n_pixels: int, out_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate traced cells (``(n_rays, steps)`` int32 padded with −1,
    ray i belonging to pixel ``pix[i]``) into the CSR skeleton, on their
    device.  Returns:

    * ``counts`` (n_pixels,) int32: unique cells per pixel over the first
      ``out_cap`` compacted entries;
    * ``cols`` (out_cap,) int32: the deduplicated cell indices, pixel-major
      and ascending within each pixel (canonical CSR order), 0 past the
      last valid entry;
    * ``nnz`` () int32: the exact number of unique (pixel, cell) pairs;
      ``nnz > out_cap`` means counts and cols were cut and the caller must
      fetch again with a larger budget."""
    dev = cells.device
    sentinel = torch.full((), _KEY_SENTINEL, dtype=torch.int32, device=dev)
    keys = torch.where(cells >= 0,
                       pix.to(torch.int32)[:, None] * n_cells + cells,
                       sentinel)
    flat = torch.sort(keys.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    valid = first & (flat != sentinel)
    nnz = torch.sum(valid, dtype=torch.int32)
    # compaction by a second sort, cut to the budget on the device
    compact = torch.sort(torch.where(valid, flat, sentinel)).values[:out_cap]
    cvalid = compact != sentinel
    cols = torch.where(cvalid, compact, 0) % n_cells
    pixel_of = torch.where(cvalid, compact // n_cells, n_pixels)
    counts = torch.zeros(n_pixels + 1, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, pixel_of.long(),
                        torch.ones_like(pixel_of, dtype=torch.int32))
    return counts[:n_pixels], cols, nnz
