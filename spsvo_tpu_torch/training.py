"""SuperPoint training: losses and the Adam update step, the counterpart of
`spsvo_tpu.training`.

  * detector loss: per-cell 65-way cross-entropy against cell-grid labels
    (the 65th "dustbin" channel = no keypoint in the cell), the SuperPoint
    paper's formulation, whose logits the pipeline's `cell_softmax`
    postprocess reads;
  * descriptor loss: hinge contrastive loss between a frame and its
    homography-warped copy (positive pairs = cells mapping onto each other,
    `io/homography.cell_correspondence`).

The model is a flat `{name: tensor}` parameter dict in the port's layout
(conv weights OIHW), run by `models.zoo.apply_fn(model)`: the serving
`GraphModule`'s forward with the dict in place of its buffers. BatchNorm
running statistics (`_is_buffer`) are frozen buffers, as in the JAX package:
BN keeps using them in training, they take no gradient and the optimizer
leaves them as they are. Every other float tensor is a leaf that takes a
gradient.

The optimizer (`Adam`, `make_optimizer`) is optax's `adam` with its
defaults on the weights and `set_to_zero` on the buffers, written out: a
learning-rate schedule is read at the update count before the increment, as
optax does. `build_sharded_train_step` is the data-parallel step over a
device mesh (parallel/mesh.py): the batch sharded over the ranks, the
gradients averaged across them, the same update on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


class AdamState(NamedTuple):
    """optax `ScaleByAdamState` over the weights: `count` updates applied,
    first and second moments `mu`, `nu` (one tensor per non-buffer
    parameter)."""
    count: int
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamState
    step: int


def detector_loss(det_logits: torch.Tensor, cell_labels: torch.Tensor
                  ) -> torch.Tensor:
    """det_logits: (B, Hc, Wc, 65); cell_labels: (B, Hc, Wc) integers in
    [0, 64] (64 = dustbin/no keypoint)."""
    logp = torch.log_softmax(det_logits, dim=-1)
    nll = -torch.gather(logp, -1, cell_labels[..., None].long())[..., 0]
    return torch.mean(nll)


def descriptor_loss(desc_a: torch.Tensor, desc_b: torch.Tensor,
                    correspondence: torch.Tensor, pos_margin: float = 1.0,
                    neg_margin: float = 0.2, lambda_d: float = 250.0
                    ) -> torch.Tensor:
    """Hinge contrastive loss over cell-grid descriptor pairs.

    desc_a/b: (B, Hc, Wc, D) L2-normalised; correspondence: (B, Hc*Wc,
    Hc*Wc) binary, 1 where cell i of A maps onto cell j of B under the
    homography.
    """
    b, hc, wc, d = desc_a.shape
    sim = torch.bmm(desc_a.reshape(b, hc * wc, d),
                    desc_b.reshape(b, hc * wc, d).transpose(1, 2))
    pos = torch.clamp(pos_margin - sim, min=0.0)
    neg = torch.clamp(sim - neg_margin, min=0.0)
    loss = correspondence * lambda_d * pos + (1.0 - correspondence) * neg
    return torch.mean(loss)


def total_loss(apply_fn, params: Params, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out_a = apply_fn(params, batch["image_a"])
    out_b = apply_fn(params, batch["image_b"])
    l_det = (detector_loss(out_a["output_det"], batch["labels_a"])
             + detector_loss(out_b["output_det"], batch["labels_b"]))
    l_desc = descriptor_loss(out_a["output_desc"], out_b["output_desc"],
                             batch["correspondence"])
    loss = l_det + l_desc
    return loss, {"loss": loss, "det_loss": l_det, "desc_loss": l_desc}


def _is_buffer(name: str) -> bool:
    """BatchNorm statistics are inference buffers, not weights: training
    them as free parameters drives running_var negative (NaN through
    rsqrt). They take no gradient and no update."""
    return name.endswith(".running_mean") or name.endswith(".running_var")


def trainable(params: Params):
    """Names of the parameters that take a gradient, in the dict's order."""
    return [k for k, v in params.items()
            if v.is_floating_point() and not _is_buffer(k)]


def value_and_grad(loss_fn: Callable[[Params], Tuple[torch.Tensor, dict]],
                   params: Params):
    """`((loss, aux), grads)` of `loss_fn(params) -> (loss, aux)`, the
    gradient w.r.t. every `trainable` tensor (zero where the loss does not
    reach one), as `jax.value_and_grad(..., has_aux=True)` gives it."""
    names = set(trainable(params))
    leaves = {k: (v.detach().requires_grad_() if k in names else v.detach())
              for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        order = [k for k in leaves if k in names]
        grads = torch.autograd.grad(loss, [leaves[k] for k in order],
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(order, grads)}
    aux = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in aux.items()}
    return (loss.detach(), aux), grads


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha) in
    float32: init * ((1 - alpha) * 0.5 * (1 + cos(pi * c / T)) + alpha)
    with c = min(count, T), the cosine rounded once from float64 (XLA's
    own float32 cosine and fusions differ by up to 2 ulp)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got "
                         f"{decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        angle = f32(np.pi) * c / f32(decay_steps)
        cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(angle))))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


# optax.adam's defaults, which the JAX package uses unchanged
B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """optax `multi_transform({"weight": adam(lr), "buffer": set_to_zero()})`
    over a parameter dict: B1, B2, EPS, eps_root 0; `lr` a float or a
    schedule of the update count, read before the increment (step 0 uses
    lr(0)). Buffers keep their values bit for bit."""

    def __init__(self, lr: LearningRate):
        self.lr = lr

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else self.lr

    def init(self, params: Params) -> AdamState:
        names = trainable(params)
        return AdamState(0, {k: torch.zeros_like(params[k]) for k in names},
                         {k: torch.zeros_like(params[k]) for k in names})

    def update(self, grads: Params, state: AdamState, params: Params
               ) -> Tuple[Params, AdamState]:
        """(params after one update, the new state); `params` and `state`
        are left as they are."""
        f32 = np.float32
        count = state.count + 1
        # optax's bias corrections, 1 - decay**count, in float32
        bc1 = float(f32(1) - f32(B1) ** f32(count))
        bc2 = float(f32(1) - f32(B2) ** f32(count))
        step = -self.learning_rate(state.count)
        mu, nu, out = {}, {}, dict(params)
        for k, g in grads.items():
            mu[k] = (1 - B1) * g + B1 * state.mu[k]
            nu[k] = (1 - B2) * (g * g) + B2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
            out[k] = params[k] + step * u
        return out, AdamState(count, mu, nu)


# the JAX package's name: Adam on the weights, nothing on the BatchNorm
# buffers (`_is_buffer` decides per update)
make_optimizer = Adam


def init_train_state(apply_fn, params: Params, lr: LearningRate = 1e-3
                     ) -> TrainState:
    return TrainState(params=dict(params),
                      opt_state=Adam(lr).init(params),
                      step=0)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
               apply_fn, lr: LearningRate = 1e-3
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One Adam step on `total_loss`; metrics are 0-dim tensors (no host
    read)."""
    (_, metrics), grads = value_and_grad(
        lambda p: total_loss(apply_fn, p, batch), state.params)
    params, opt_state = Adam(lr).update(grads, state.opt_state, state.params)
    return TrainState(params, opt_state, state.step + 1), metrics


class ShardedTrainStep:
    """`step(state, batch) -> (state, metrics)`, `train_step` data-parallel
    over a mesh. Every rank calls it with the same full batch; rank r
    takes its rows [r B / w, (r + 1) B / w) (`mesh.shard_bounds`), computes
    their loss and gradients with `value_and_grad`, and one
    `Mesh.all_reduce_mean` weighted by the row counts gives every rank the
    whole batch's mean gradient and metrics. The same `Adam.update` then
    runs on every rank, so the parameters and the optimizer state stay
    replicated: rank 0's are broadcast once, at the first call. BatchNorm
    statistics stay frozen (`_is_buffer`)."""

    def __init__(self, apply_fn, mesh, lr: LearningRate = 1e-3):
        self.apply_fn, self.mesh, self.lr = apply_fn, mesh, lr
        self._replicated = False

    def replicate(self, state: TrainState) -> TrainState:
        """Rank 0's parameters, moments and counts on every rank."""
        p, opt = state.params, state.opt_state
        names, moments = list(p), list(opt.mu)
        dev = self.mesh.device
        counts = torch.tensor([opt.count, state.step], dtype=torch.int64,
                              device=dev)
        got = self.mesh.broadcast(
            [p[k].to(dev) for k in names]
            + [opt.mu[k].to(dev) for k in moments]
            + [opt.nu[k].to(dev) for k in moments] + [counts])
        n, m = len(names), len(moments)
        count, step = (int(v) for v in got[-1].tolist())
        return TrainState(dict(zip(names, got[:n])),
                          AdamState(count, dict(zip(moments, got[n:n + m])),
                                    dict(zip(moments, got[n + m:n + 2 * m]))),
                          step)

    def metrics_and_grads(self, params: Params,
                          batch: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], Params]:
        """The whole batch's metrics and mean gradient, on every rank:
        this rank's rows through `value_and_grad`, then one weighted
        `all_reduce_mean`."""
        from spsvo_tpu_torch.parallel.mesh import shard_bounds
        mesh = self.mesh
        rows = next(iter(batch.values())).shape[0]
        if rows < mesh.size:
            raise ValueError(f"a batch of {rows} over {mesh.size} ranks")
        a, b = shard_bounds(rows, mesh.size)[mesh.rank]
        local = {k: v[a:b].to(mesh.device) for k, v in batch.items()}
        (_, metrics), grads = value_and_grad(
            lambda p: total_loss(self.apply_fn, p, local), params)
        g_names: List[str] = list(grads)
        m_names: List[str] = list(metrics)
        mean = mesh.all_reduce_mean([grads[k] for k in g_names]
                                    + [metrics[k] for k in m_names],
                                    weight=float(b - a))
        return (dict(zip(m_names, mean[len(g_names):])),
                dict(zip(g_names, mean[:len(g_names)])))

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not self._replicated:
            state = self.replicate(state)
            self._replicated = True
        metrics, grads = self.metrics_and_grads(state.params, batch)
        params, opt_state = Adam(self.lr).update(grads, state.opt_state,
                                                 state.params)
        return TrainState(params, opt_state, state.step + 1), metrics


def build_sharded_train_step(apply_fn, mesh, lr: LearningRate = 1e-3
                             ) -> ShardedTrainStep:
    """The data-parallel train step over `mesh` (`parallel.mesh.make_mesh`;
    see `ShardedTrainStep`). The JAX package's `axis_name` has no
    counterpart: a mesh here has one axis."""
    from spsvo_tpu_torch.parallel.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError("build_sharded_train_step: mesh must be a "
                        "spsvo_tpu_torch.parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh)}")
    return ShardedTrainStep(apply_fn, mesh, lr)


def synthetic_batch(batch: int, h: int, w: int, *,
                    generator: torch.Generator, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Random-label training batch (uniform images, uniform labels, identity
    correspondence), drawn on the generator's device and moved to
    `device`."""
    hc, wc = h // 8, w // 8
    gdev = generator.device

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=gdev)

    def labels():
        return torch.randint(0, 65, (batch, hc, wc), generator=generator,
                             device=gdev, dtype=torch.int32)

    out = {"image_a": uniform((batch, h, w, 1)),
           "image_b": uniform((batch, h, w, 1)),
           "labels_a": labels(), "labels_b": labels(),
           "correspondence": torch.eye(hc * wc, device=gdev).expand(
               batch, hc * wc, hc * wc).contiguous()}
    return {k: v.to(device) for k, v in out.items()}
