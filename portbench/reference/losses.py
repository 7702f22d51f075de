# Frozen copy of side_tpu_torch/ops/losses.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
# Edit: no mesh.
"""Training losses for stereo CenterNet (port of side_tpu/ops/losses.py).

Penalty-reduced focal loss (from logits, with saturation-safe gradients),
masked-then-mean L1, unmasked grid cross-entropy, the depth-bin soft-target
cross-entropy, and the Kendall uncertainty-weighted total.  Feature maps are
NHWC, as the network returns them.

Every part is a sum over the batch divided by a count over the batch.
Within `parallel.mesh.data_parallel` each rank's part is its share of the
global part, so that the ranks' gradients sum to the gradient of the
one-process loss on the joined batch: a mean over a fixed count is the
local mean over the world size (the ranks hold equal shards), and the
counts that depend on the data (focal's positives, the valid depth slots)
are summed over the ranks (one all-reduce, no gradient).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .nomesh import active_mesh, all_reduce_
from .decode import gather_feat


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid clamped away from {0, 1}."""
    return torch.clamp(torch.sigmoid(x), 1e-4, 1.0 - 1e-4)


def _focal_sums(log_p, log_1p, pred, gt):
    """(positive term, negative term, number of positives), summed."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = (log_p * torch.pow(1.0 - pred, 2) * pos).sum()
    neg_loss = (log_1p * torch.pow(pred, 2) * neg_weights * neg).sum()
    return pos_loss, neg_loss, pos.sum()


def _focal_value(pos_loss, neg_loss, num_pos):
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def _focal(log_p, log_1p, pred, gt):
    return _focal_value(*_focal_sums(log_p, log_1p, pred, gt))


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet penalty-reduced focal loss; pred is a sigmoided heatmap."""
    return _focal(torch.log(pred), torch.log(1.0 - pred), pred, gt)


def _focal_logit_sums(logits, gt):
    return _focal_sums(-F.softplus(-logits), -F.softplus(logits),
                       clamped_sigmoid(logits), gt)


def focal_loss_logits(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """focal_loss from raw logits: the log-probabilities come from softplus,
    so a positive whose prediction saturates keeps a gradient; the focal
    power weights use the clamped probabilities (value only)."""
    return _focal_value(*_focal_logit_sums(logits, gt))


def masked_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """L1 over gathered cells, zero outside mask, MEAN over all B*K*C slots."""
    pred = gather_feat(output, ind)
    m = mask[..., None].to(pred.dtype)
    return (pred * m - target * m).abs().mean()


def cross_loss(output: torch.Tensor, ind: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over grid logits at gathered cells, with no validity
    mask (empty slots train towards class 0, as the reference does)."""
    logp = F.log_softmax(gather_feat(output, ind), dim=-1)
    picked = torch.gather(logp, -1, target[..., None].long())[..., 0]
    return -picked.mean()


def compute_kept_label(kept: torch.Tensor, wh: torch.Tensor,
                       grid: int) -> torch.Tensor:
    """Keypoint grid quantiser: kept (B, K, 6), wh (B, K, 3) -> (B, K, 3)
    int class targets [kpt_type*grid + cell, border_left, border_right]."""
    width = wh[..., 0:1] + 1.0
    t = torch.round(kept * grid / width)
    t = torch.where((t < 0) | (t > grid - 1), torch.full_like(t, -225.0), t)
    kpts_pos = t[..., :4].max(dim=-1).values
    kpts_type = torch.argmax(t[..., :4], dim=-1).to(t.dtype)
    merged = torch.stack([kpts_type * grid + kpts_pos, t[..., 4], t[..., 5]],
                         dim=-1)
    return torch.clamp(merged, min=0.0).to(torch.int32)


def _depth_bin_ce_sums(logits, depth_bin, gt_depth):
    """(cross-entropy summed over the valid slots, number of them)."""
    valid = gt_depth > 0
    D = depth_bin.shape[-1]
    spacing = torch.clamp((depth_bin[..., 0] - depth_bin[..., -1]) /
                          max(D - 1, 1), min=0.5)
    d2 = (depth_bin - gt_depth[..., None]) ** 2
    q = torch.softmax(-d2 / (2.0 * spacing[..., None] ** 2), dim=-1)
    ce = -(q * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return torch.where(valid, ce, torch.zeros_like(ce)).sum(), valid.sum()


def depth_bin_ce(logits: torch.Tensor, depth_bin: torch.Tensor,
                 gt_depth: torch.Tensor) -> torch.Tensor:
    """Soft-target cross-entropy over the cost volume's depth-bin logits: a
    gaussian of one bin spacing around the GT depth.  logits, depth_bin
    (B, K, D); gt_depth (B, K), 0 = invalid slot."""
    ce, n = _depth_bin_ce_sums(logits, depth_bin, gt_depth)
    return ce / torch.clamp(n, min=1)


def stereo_loss(outputs: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], loss_weight: torch.Tensor,
                grid: int, uncert: bool, use_cost_volume: bool,
                depth_aux_weight: float = 0.0, mse_loss: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total stereo loss.  `loss_weight` is the 7-vector [hm, wh, off,
    depth, dim, orien, kept]; with `uncert` it is the learned log-variance s
    and the total is sum(L_i exp(-s_i) + s_i).  `mse_loss` swaps the focal
    loss for the MSE of the clamped sigmoid.

    Within `data_parallel(mesh)` the returned total is this rank's share,
    sum(L_i^local exp(-s_i) + s_i / world) (L_i^local: the rank's sum over
    the global count), to back-propagate; the stats are the global parts
    and total, summed over the ranks and detached."""
    mesh = active_mesh()
    hm_gt = batch["hm"]
    if hm_gt.shape != outputs["hm"].shape:   # targets (B, C, H, W) -> NHWC
        hm_gt = hm_gt.permute(0, 2, 3, 1)
    focal = ce = None
    if mse_loss:
        hm_loss = ((clamped_sigmoid(outputs["hm"]) - hm_gt) ** 2).mean()
    else:
        focal = _focal_logit_sums(outputs["hm"], hm_gt)

    mask, ind = batch["rot_mask"], batch["ind"]
    dim_loss = masked_l1_loss(outputs["dim"], mask, ind, batch["dim"])
    orien_loss = masked_l1_loss(outputs["orien"], mask, ind, batch["orien"])
    wh_loss = masked_l1_loss(outputs["wh"], mask, ind, batch["wh"])
    off_loss = masked_l1_loss(outputs["reg"], mask, ind, batch["reg"])

    target = compute_kept_label(batch["kept"], batch["wh"], grid)
    kt = outputs["kept_type"]
    kept_loss = (cross_loss(kt[..., :4 * grid], ind, target[..., 0]) +
                 cross_loss(kt[..., 4 * grid:5 * grid], ind, target[..., 1]) +
                 cross_loss(kt[..., 5 * grid:], ind, target[..., 2])) / 3.0

    if use_cost_volume:
        depth_loss = (outputs["depth"] - batch["depth"]).abs().mean()
        if depth_aux_weight > 0 and "depth_logits" in outputs:
            ce = _depth_bin_ce_sums(outputs["depth_logits"],
                                    outputs["depth_bin"],
                                    batch["depth"][..., 0])
    else:
        depth_loss = kept_loss.new_zeros(())

    if mesh is not None:
        # this rank's shares of the global parts: a mean over a fixed count
        # over the world size, a sum over a count summed over the ranks
        w = mesh.world
        if focal is None:
            hm_loss = hm_loss / w
        wh_loss, off_loss, depth_loss, dim_loss, orien_loss, kept_loss = (
            t / w for t in (wh_loss, off_loss, depth_loss, dim_loss,
                            orien_loss, kept_loss))
        zero = kept_loss.new_zeros(())
        n = all_reduce_(torch.stack([
            (zero if focal is None else focal[2]).detach().float(),
            (zero if ce is None else ce[1]).float()]), mesh)
        if focal is not None:
            focal = (focal[0], focal[1], n[0])
        if ce is not None:
            ce = (ce[0], n[1])
    if focal is not None:
        hm_loss = _focal_value(*focal)
    if ce is not None:
        depth_loss = depth_loss + depth_aux_weight * (
            ce[0] / torch.clamp(ce[1], min=1))

    parts = torch.stack([hm_loss, wh_loss, off_loss, depth_loss, dim_loss,
                         orien_loss, kept_loss])
    lw = torch.as_tensor(loss_weight, dtype=parts.dtype, device=parts.device)
    if uncert:
        total = (parts * torch.exp(-lw) +
                 (lw if mesh is None else lw / mesh.world)).sum()
    else:
        total = (parts * lw).sum()
    shown, shown_total = parts, total
    if mesh is not None:
        shown = all_reduce_(parts.detach().clone(), mesh)
        shown_total = ((shown * torch.exp(-lw) + lw).sum() if uncert
                       else (shown * lw).sum()).detach()
    names = ("hm_loss", "wh_loss", "off_loss", "depth_loss", "dim_loss",
             "orien_loss", "kept_loss")
    stats = {"loss": shown_total}
    stats.update({n: shown[i] for i, n in enumerate(names)
                  if n != "depth_loss" or use_cost_volume})
    return total, stats
