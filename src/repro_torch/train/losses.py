"""Loss functions of the trainer (``repro/train/losses.py``).

``next_token_loss`` is the LM objective: masked next-token cross entropy
in fp32, with optional z-loss (a logit-norm regularizer) and label
smoothing.
"""
from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                    z_loss: float = 0.0, label_smoothing: float = 0.0):
    """Masked next-token CE (``losses.py:14``). logits (B, S, V): position t
    predicts token t + 1; tokens (B, S) int, 0 = pad. Returns
    (loss, metrics)."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    ce_tok = logz - gold
    if label_smoothing:
        # Uniform smoothing: (1-eps)*gold + eps*mean over vocab.
        mean_lp = torch.mean(lg, dim=-1) - logz
        ce_tok = (1 - label_smoothing) * ce_tok - label_smoothing * mean_lp
    mask = (targets != 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum(ce_tok * mask) / denom
    metrics = {"ce": ce, "tokens": denom}
    loss = ce
    if z_loss:
        zl = torch.sum(torch.square(logz) * mask) / denom
        loss = loss + z_loss * zl
        metrics["z_loss"] = zl
    metrics["ppl_proxy"] = torch.exp(torch.clamp(ce, max=20.0))
    return loss, metrics
