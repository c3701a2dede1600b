"""The gridding SpMM K3's share of its roofline over the traced stretch:
the frozen bound (``roofline.bounds.spmm_bound``) of one apply of the
Kaiser-Bessel gridding matrix that the plain reference builds itself, on
as many real columns as the operator applies it to (two per coil), times
K3's launches in the stretch, over their device time. The matrix and its
transpose have the same bound, so every launch counts alike."""
import re

import torch

from portbench.lib.readers import kernel_seconds
from portbench.reference import common
from portbench.roofline.bounds import spmm_bound

K3_KERNELS = re.compile(r"^row_spmm<")


def reference_nnz(cfg, traj, device):
    grid = tuple(common.grid_size(n, cfg["oversamp"]) for n in cfg["image"])
    idx, _ = common.kb_taps(
        torch.as_tensor(traj, dtype=torch.float64, device=device), grid,
        cfg["width"], common.beatty_beta(cfg["width"], cfg["oversamp"]),
        torch.float64)
    s = torch.sort(idx, dim=1).values
    distinct = 1 + torch.count_nonzero(s[:, 1:] != s[:, :-1], dim=1)
    return int(distinct.sum()), idx.shape[0], int(torch.tensor(grid).prod())


def read(ctx):
    s = ctx.summary
    if not s:
        return None
    seconds, launches = kernel_seconds(s, K3_KERNELS)
    if not seconds:
        return None
    c = ctx.cfg
    nnz, rows, cols = reference_nnz(c, ctx.system.traj, ctx.device)
    bound_ms, _ = spmm_bound(nnz, rows, cols, 2 * c["coils"])
    return 100.0 * launches * bound_ms / (1e3 * seconds)
