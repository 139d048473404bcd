"""Maximum-likelihood flow training (counterpart of ``aspire_tpu/flows/train.py``).

Shuffle, train/validation split, Adam (optionally AdamW) with a cosine
learning-rate decay and global-norm gradient clipping, early stopping with
patience and best-state restore. The optimizer is written out so one step
matches ``optax.chain(clip_by_global_norm, adam(cosine_decay_schedule))``
of the JAX package to round-off. Training runs the plain torch path with
autograd, as the JAX package trains through XLA rather than its kernels.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable

import torch

from ..history import FlowHistory

logger = logging.getLogger("aspire_tpu_torch")


@dataclasses.dataclass
class TrainConfig:
    n_epochs: int = 100
    batch_size: int = 128
    learning_rate: float = 1e-3
    validation_fraction: float = 0.1
    patience: int = 20
    annealing: bool = True
    max_grad_norm: float = 5.0
    weight_decay: float = 0.0
    min_delta: float = 0.0


def cosine_decay(init: float, decay_steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(init, decay_steps)`` (alpha 0)."""
    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
    return schedule


class Adam:
    """Global-norm clipping, then Adam(W) with a learning-rate schedule.

    Updates the parameter tensors in place; ``step`` takes the gradients
    in the same order as the parameters.
    """

    def __init__(self, params: list[torch.Tensor], schedule, max_grad_norm,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.where(g_norm < self.max_grad_norm,
                            torch.ones_like(g_norm),
                            self.max_grad_norm / g_norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay > 0:
                update = update + self.weight_decay * p
            p.sub_(lr * update)


def make_optimizer(params: list[torch.Tensor], config: TrainConfig,
                   total_steps: int) -> Adam:
    schedule = (cosine_decay(config.learning_rate, total_steps)
                if config.annealing else (lambda _: config.learning_rate))
    return Adam(params, schedule, config.max_grad_norm,
                weight_decay=config.weight_decay)


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tensors of a nested ``{"layers": [...]}`` dict down to
    its dense layers, each ``w`` then ``b``, in layer order: a flow's stack
    of networks or one MLP (the CNF's velocity field)."""
    if "w" in params:
        return [params["w"], params["b"]]
    return [t for sub in params["layers"] for t in param_leaves(sub)]


def clone_params(params):
    """A detached copy of a parameter dict, its nesting kept."""
    if isinstance(params, torch.Tensor):
        return params.detach().clone()
    if isinstance(params, dict):
        return {k: clone_params(v) for k, v in params.items()}
    return [clone_params(v) for v in params]


def _sharded_mean(loss: torch.Tensor, grads, mesh):
    """The means over the ranks of this rank's loss and gradients (every
    rank's the same bits): one exchange of all of them."""
    from ..parallel.mesh import all_reduce

    flat = torch.cat([loss.detach().reshape(1),
                      *(g.reshape(-1) for g in grads)])
    flat = all_reduce(flat, mesh) / mesh.size
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return flat[0], out


def fit_flow(loss_fn: Callable, params: dict, x: torch.Tensor,
             generator: torch.Generator, config: TrainConfig,
             sharding=None) -> tuple[dict, FlowHistory]:
    """Minimise ``loss_fn(params, batch)``; returns (best params, history).
    A loss that draws (the CNF's) draws from its own generator at every
    call, the validation loss's included; on a mesh it is called as
    ``loss_fn(params, batch, mesh)`` for a batch of this rank's rows, and
    draws at the whole batch's shape.

    ``sharding`` (:func:`~aspire_tpu_torch.parallel.mesh.particle_sharding`)
    trains data-parallel over its mesh: every rank passes the whole ``x``
    and shuffles it alike on its generator; the training and validation
    sets are trimmed to a multiple of the mesh size (as the JAX package
    trims them), ``batch_size`` is the global batch (it must divide by the
    mesh size), each rank takes its rows of every batch and of the
    validation set, and the losses and gradients are averaged over the
    ranks, so the parameters stay the same on every rank bit for bit."""
    if not bool(torch.isfinite(x).all()):
        raise ValueError("Training data contains NaN or inf values")
    n = x.shape[0]
    x = x[torch.randperm(n, generator=generator, device=x.device)]
    n_val = int(config.validation_fraction * n)
    n_train = n - n_val
    x_train, x_val = x[n_val:], x[:n_val]
    batch_size = min(config.batch_size, n_train)
    n_batches = max(n_train // batch_size, 1)
    mesh, val_sharded = None, False
    if sharding is not None and not sharding.replicated:
        mesh = sharding.mesh
        n_train = (n_train // mesh.size) * mesh.size
        x_train = x_train[:n_train]
        batch_size = min(config.batch_size, n_train)
        if batch_size % mesh.size:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the mesh "
                f"size ({mesh.size}): each rank takes its rows of a batch")
        n_batches = max(n_train // batch_size, 1)
        n_val_even = (n_val // mesh.size) * mesh.size
        if n_val_even:
            x_val, val_sharded = mesh.local_rows(x_val[:n_val_even]), True

    params = clone_params(params)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = make_optimizer(leaves, config, config.n_epochs * n_batches)
    history = FlowHistory()
    best_val, best_params, since = math.inf, clone_params(params), 0
    for epoch in range(config.n_epochs):
        order = torch.randperm(n_train, generator=generator,
                               device=x.device)
        batches = x_train[order[: n_batches * batch_size]].reshape(
            n_batches, batch_size, -1)
        losses = []
        for batch in batches:
            if mesh is not None:
                batch = mesh.local_rows(batch)
            # Autograd on also when the caller has it off (a flow
            # preconditioning fits inside an SMC mutation).
            with torch.enable_grad():
                loss = (loss_fn(params, batch) if mesh is None
                        else loss_fn(params, batch, mesh))
                grads = torch.autograd.grad(loss, leaves)
            if mesh is not None:
                loss, grads = _sharded_mean(loss, grads, mesh)
            opt.step(list(grads))
            losses.append(loss.detach())
        train_loss = float(torch.stack(losses).mean())
        if n_val:
            with torch.no_grad():
                val = (loss_fn(params, x_val, mesh) if val_sharded
                       else loss_fn(params, x_val))
                if val_sharded:
                    val = _sharded_mean(val, (), mesh)[0]
                val_loss = float(val)
        else:
            val_loss = train_loss
        history.training_loss.append(train_loss)
        history.validation_loss.append(val_loss)
        if val_loss < best_val - config.min_delta:
            best_val, best_params, since = val_loss, clone_params(params), 0
        else:
            since += 1
        if since >= config.patience:
            logger.info("Early stopping at epoch %d (best val loss %.4f)",
                        epoch + 1, best_val)
            break
    return best_params, history
