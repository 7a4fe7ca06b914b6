"""Input batches: the dry run's input specs and synthetic data.

``train_specs`` / ``prefill_specs`` say what every (arch x shape) cell
feeds its step: each input leaf as a tensor on the ``meta`` device (shape
and dtype, no storage), the structure ``make_batch`` materializes.
``launch/dryrun.py`` draws its inputs from them; ``batch_axes`` names the
logical axes of every leaf (``launch/programs.py`` shards them).

The reference draws its tokens with ``jax.random``; the port cannot import
it and draws from ``np.random.default_rng([seed, step, host_index])``. So
its batches differ from the reference's in value, and keep its contract:
deterministic, restartable at any cursor, one shard per host.

On a mesh (``place_batch``, ``TokenStream(mesh=...)``) every rank draws the
same global batch from the same seed and keeps its own rows as a DTensor
split over "data" by ``batch_axes``, so no bytes move. With microbatches a
rank's rows are laid out microbatch by microbatch (``batch_order``), so
that the step's microbatch i is the reference's contiguous global rows
[i B/mb, (i+1) B/mb) without narrowing a split DTensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeCell

BF16 = torch.bfloat16


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions after reserving frontend (patch) positions."""
    if cfg.frontend == "vision_patches":
        return seq_len - cfg.frontend_tokens
    return seq_len


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embed_specs(cfg: ModelConfig, B: int, S: int, dtype) -> dict:
    spec = {}
    if cfg.frontend == "vision_patches":
        spec["patch_embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model), dtype)
    if cfg.is_encoder_decoder:
        spec["enc_embeds"] = _spec((B, S, cfg.d_model), dtype)
    return spec


def train_specs(cfg: ModelConfig, cell: ShapeCell, dtype=BF16) -> dict:
    """The inputs of one train step of ``cell``: tokens and targets (B, S)
    int32, and the frontend or encoder embeddings where the arch has them."""
    B, S = cell.global_batch, cell.seq_len
    st = _text_len(cfg, S)
    return {"tokens": _spec((B, st), torch.int32), "targets": _spec((B, st), torch.int32),
            **_embed_specs(cfg, B, S, dtype)}


def prefill_specs(cfg: ModelConfig, cell: ShapeCell, dtype=BF16) -> dict:
    """The inputs of one prefill of ``cell``: tokens (B, S) int32, and the
    frontend or encoder embeddings where the arch has them."""
    B, S = cell.global_batch, cell.seq_len
    return {"tokens": _spec((B, _text_len(cfg, S)), torch.int32),
            **_embed_specs(cfg, B, S, dtype)}


def batch_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical sharding axes for every input leaf."""
    ax = {
        "tokens": ("batch", "seq"),
        "targets": ("batch", "seq"),
        "patch_embeds": ("batch", "seq", "embed"),
        "enc_embeds": ("batch", "seq", "embed"),
    }
    return ax


def make_batch(rng: np.random.Generator, cfg: ModelConfig, *, batch: int, seq: int,
               kind: str = "train", device="cuda") -> dict:
    """Deterministic synthetic batch of ``seq`` positions: tokens (B,St) int32
    and, for training, the next-token targets (B,St) int32, St = ``seq``
    less a vision frontend's patch positions (``_text_len``); a vision
    frontend's ``patch_embeds`` (B, frontend_tokens, d_model) and an
    encoder-decoder's ``enc_embeds`` (B, seq, d_model), float32 standard
    normals. Everything is drawn from ``rng``, tokens first."""
    st = _text_len(cfg, seq)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, st + 1)).astype(np.int32)).to(device)
    out = {"tokens": toks[:, :-1]}
    if kind == "train":
        out["targets"] = toks[:, 1:]
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)).to(device)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32)).to(device)
    return out


class TokenStream:
    """Deterministic, restartable, shardable synthetic token pipeline.

    Each host pulls only its shard of the global batch (by host index), and
    the stream position is checkpointable (``state()`` / ``seek()``), which
    the fault-tolerant trainer relies on for exact restart.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1, device="cuda", mesh=None,
                 rules=None, microbatches: int = 1):
        """``mesh`` (with ``rules``): every rank draws the global batch and
        keeps its rows as DTensors (``place_batch``, laid out for
        ``microbatches``): the batches are those of the stream without a
        mesh."""
        self.mesh, self.rules, self.microbatches = mesh, rules, microbatches
        if batch % host_count:
            raise ValueError(f"batch {batch} does not split over {host_count} hosts")
        self.cfg = cfg
        self.global_batch = batch
        self.local_batch = batch // host_count
        self.seq = seq
        self.seed = seed
        self.host_index = host_index
        self.device = device
        self.step = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def seek(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"stream seed {state['seed']} on restore, {self.seed} here")
        self.step = int(state["step"])

    def next(self) -> dict:
        rng = np.random.default_rng([self.seed, self.step, self.host_index])
        self.step += 1
        out = make_batch(rng, self.cfg, batch=self.local_batch, seq=self.seq,
                         kind="train", device=self.device)
        if self.mesh is not None:
            out = place_batch(out, self.mesh, self.rules, microbatches=self.microbatches)
        return out


def batch_order(B: int, microbatches: int, parts: int) -> list[int]:
    """The global rows, in the order a batch placed by ``place_batch`` holds
    them (its ``full_tensor()``'s rows): split into ``parts`` over the batch
    axes, each part's rows microbatch by microbatch."""
    mb, per = microbatches, B // (microbatches * parts)
    return [i * (B // mb) + r * per + t for r in range(parts) for i in range(mb)
            for t in range(per)]


def _split_coord(mesh, entry) -> tuple[int, int]:
    """(parts, this rank's index) of a spec entry's mesh axes, the first
    outermost."""
    axes = entry if isinstance(entry, tuple) else (entry,) if entry else ()
    parts, idx = 1, 0
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        idx = idx * n + mesh.get_local_rank(a)
        parts *= n
    return parts, idx


def place_batch(batch: dict, mesh, rules, *, microbatches: int = 1, kind: str = "train") -> dict:
    """The global ``batch`` (the same whole tensors on every rank) as
    DTensors on ``mesh``, placed by ``batch_axes`` under ``rules``: each rank
    keeps its rows (and its slice of any other split dim), with no
    communication. With ``microbatches`` the rows a rank holds are its part
    of microbatch 0, then of microbatch 1, ...: ``batch_order``."""
    from ..parallel.sharding import local_rows, tree_shardings

    axes = batch_axes(None, kind)
    sh = tree_shardings({k: axes[k] for k in batch}, batch, rules, mesh)
    out = {}
    for k, t in batch.items():
        spec = sh[k].spec
        parts, r = _split_coord(mesh, spec[0])
        if t.shape[0] % (parts * microbatches):
            raise ValueError(f"{k}: {t.shape[0]} rows do not split into {microbatches} "
                             f"microbatches over {parts} ranks")
        rows = batch_order(t.shape[0], microbatches, parts)
        n = t.shape[0] // parts
        loc = t[rows[r * n:(r + 1) * n]] if microbatches > 1 else t[r * n:(r + 1) * n]
        for dim in range(1, t.dim()):
            p, i = _split_coord(mesh, spec[dim])
            if p > 1:
                loc = loc.chunk(p, dim)[i]
        out[k] = local_rows(loc.contiguous(), sh[k])
    return out
