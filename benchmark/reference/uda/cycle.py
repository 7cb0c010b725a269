"""Temporal cycle-consistency loss, in float32 (a frozen copy of the system's math)
(reference `Trainer.seg_cycle`, `train_cardiac_uda.py:428-494`).

Soft nearest-neighbour cycle alignment on the per-frame backbone features of
one clip: a chunk of query frames from a random start is matched against the
shifted windows of the key half, the softmax-weighted key windows are matched
back against the query half, and a BCE asks for the original start. The start
is an argument (a 0-d index tensor), drawn by the step through `draw_starts`;
windows are index grids and gathers, so nothing waits on the host.
"""

from __future__ import annotations

import torch

from benchmark.reference.uda.losses import bce_with_logits


def n_starts(target_region: int = 16, cyc_off: int = 2, chunk_size: int = 4) -> int:
    """How many start positions a query chunk has."""
    return target_region - (chunk_size + cyc_off) + 1


def draw_starts(generator: torch.Generator, n_clips: int, target_region: int = 16,
                cyc_off: int = 2, chunk_size: int = 4) -> torch.Tensor:
    """(n_clips,) uniform start indices from `generator`, on its device (the
    reference's `np.random.choice`)."""
    return torch.randint(0, n_starts(target_region, cyc_off, chunk_size), (n_clips,),
                         generator=generator, device=generator.device)


def seg_cycle(feat_out: torch.Tensor, start: torch.Tensor, target_region: int = 16,
              cyc_off: int = 2, chunk_size: int = 4, temperature: float = 10.0) -> torch.Tensor:
    """feat_out: (T, F) per-frame features, start: 0-d index tensor. Returns
    the scalar BCE cycle loss. Defaults are the reference call's
    (`train_cardiac_uda.py:251`)."""
    # a clip shorter than target_region + one key window leaves the key half
    # empty and the loss silently NaN (empty softmax)
    assert feat_out.shape[0] >= target_region + chunk_size + cyc_off, (
        f"seg_cycle needs clip_length >= target_region + chunk_size + cyc_off "
        f"({target_region}+{chunk_size}+{cyc_off}), got T={feat_out.shape[0]}")
    feat_dim = feat_out.shape[1]
    dev = feat_out.device
    fq = feat_out[:target_region]
    fq_cyc = feat_out[cyc_off:target_region]
    fk = feat_out[target_region:]
    key_size = fk.shape[0]

    starts = n_starts(target_region, cyc_off, chunk_size)
    start = start.to(dev).long()
    onehot = torch.nn.functional.one_hot(start, starts).to(feat_out.dtype)
    query = fq.index_select(0, start + torch.arange(chunk_size, device=dev))

    # forward match: the query chunk against shifted key windows (`:443-454`)
    d = torch.sum((fk[:, None, :] - query[None, :, :]) ** 2, dim=-1)  # (K, chunk)
    shift = (torch.arange(key_size, device=dev)[:, None]
             + torch.arange(chunk_size, device=dev)[None, :]) % key_size
    d_shift = torch.gather(d, 0, shift)[:key_size - (chunk_size + cyc_off) + 1]
    similarity = -torch.sum(d_shift, dim=1)
    beta = torch.softmax(similarity / feat_dim / chunk_size * temperature, dim=0)

    # softmax-weighted key windows (`:461-469`)
    fk_beta = fk[shift][cyc_off:key_size - chunk_size + 1]  # (K', chunk, F)
    weighted = torch.sum(beta[:, None, None] * fk_beta, dim=0)  # (chunk, F)

    # cycle back: the weighted chunk against shifted query windows (`:472-487`)
    qd = torch.sum((fq_cyc[:, None, :] - weighted[None, :, :]) ** 2, dim=-1)
    tq = target_region - cyc_off
    qshift = (torch.arange(tq, device=dev)[:, None]
              + torch.arange(chunk_size, device=dev)[None, :]) % tq
    qd_shift = torch.gather(qd, 0, qshift)[:tq - chunk_size + 1]
    q_similarity = -torch.sum(qd_shift, dim=1) / feat_dim / chunk_size * temperature
    return bce_with_logits(q_similarity, onehot)
