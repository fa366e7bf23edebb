"""Pairwise similarities and the (symmetric) InfoNCE contrastive loss
(counterpart of ``dib_tpu/ops/similarity.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-9


def pairwise_sqeuclidean(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """[N, M] squared L2 distances in the norm-expansion (matmul) form."""
    n1 = pts1.square().sum(-1, keepdim=True)
    n2 = pts2.square().sum(-1)[None, :]
    return torch.clamp_min(n1 + n2 - 2.0 * (pts1 @ pts2.T), 0.0)


def pairwise_l1(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    return (pts1[:, None, :] - pts2[None, :, :]).abs().sum(-1)


def pairwise_linf(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    return (pts1[:, None, :] - pts2[None, :, :]).abs().amax(-1)


def scaled_similarity(embeddings1: torch.Tensor, embeddings2: torch.Tensor,
                      similarity_type: str = "l2", temperature: float = 1.0) -> torch.Tensor:
    """[N, M] similarity divided by ``temperature``: negated distances
    ('l2sq', 'l2', 'l1', 'linf') or cosine similarity."""
    if similarity_type == "l2sq":
        sim = -pairwise_sqeuclidean(embeddings1, embeddings2)
    elif similarity_type == "l2":
        # eps inside the sqrt keeps the gradient finite at zero distance
        sim = -torch.sqrt(pairwise_sqeuclidean(embeddings1, embeddings2) + _EPS)
    elif similarity_type == "l1":
        sim = -pairwise_l1(embeddings1, embeddings2)
    elif similarity_type == "linf":
        sim = -pairwise_linf(embeddings1, embeddings2)
    elif similarity_type == "cosine":
        e1 = embeddings1 / (embeddings1.norm(dim=-1, keepdim=True) + _EPS)
        e2 = embeddings2 / (embeddings2.norm(dim=-1, keepdim=True) + _EPS)
        sim = e1 @ e2.T
    else:
        raise ValueError(f"Similarity type not implemented: {similarity_type}")
    return sim / temperature


def infonce_loss(similarity_matrix: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of each row against its diagonal entry (nats)."""
    labels = torch.arange(similarity_matrix.shape[0], device=similarity_matrix.device)
    return F.cross_entropy(similarity_matrix, labels)


def symmetric_infonce(embeddings1: torch.Tensor, embeddings2: torch.Tensor,
                      similarity_type: str = "l2", temperature: float = 1.0,
                      halved: bool = False) -> torch.Tensor:
    """Row-wise + column-wise InfoNCE against the matched diagonal
    (``halved`` divides the sum by two)."""
    sim = scaled_similarity(embeddings1, embeddings2, similarity_type, temperature)
    loss = infonce_loss(sim) + infonce_loss(sim.T)
    return loss / 2.0 if halved else loss
