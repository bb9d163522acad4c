"""Ranger21 as a ``torch.optim.Optimizer`` (`intrepppid_tpu/optim/ranger21.py:57-322`).

The reference pins ``ranger21==0.1.0`` (Wright & Demeure, arXiv:2106.13731)
with ``lr, weight_decay=1e-2, warmdown_start_pct=0.72``, in two variants:
``ranger21`` (no warmup/warmdown) and ``ranger21_xx`` (linear warmup and
warmdown). Components, with the pinned package's quirks (see
``tests/ranger21_oracle.py``, the hand-port every update is held against):

* adaptive gradient clipping per unit: ``g`` clipped to ``0.01 *
  max(unit_norm(p), 1e-3)``;
* gradient centralisation over all non-leading dims of gradients with
  ndim > 1;
* positive-negative momentum: two EMAs with ``beta1^2`` updated on
  alternating steps, combined as ``((1+γ) m_cur - γ m_prev) / sqrt((1 +
  beta2)^2 + beta2^2)`` (the package's beta2-based normaliser);
* Adam second moment, bias-corrected, softplus-smoothed denominator
  (``softplus(sqrt(v̂) + eps, beta=50)``);
* stable weight decay scaled by the RMS of the second moment pooled over
  all parameters;
* norm loss pulling each unit's norm toward 1;
* lookahead (k = 5, α = 0.5);
* the linear warmup / warmdown schedule of :func:`ranger21_lr_schedule`.

Unit norms: whole tensor for ndim <= 1, axis 1 for ndim 2 and 3, axes 1-3
for ndim 4. A param group with ``direction_stacked=True`` holds tensors
whose leading axis stacks separate tensors of the reference (the port's
LSTM weights stack the two directions): unit norms and centralisation then
act on each slice alone, as they do on the reference's per-direction
tensors. A group's ``update_scale`` (default 1) multiplies the final update
``new_p - p``, as the JAX trainer's ``lr_scale`` does. The step count
travels in ``state_dict()`` (``"count"``), as it does in the JAX
package's optax state, so a resumed run keeps its schedule.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _unit_norm(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Ranger21's unit norm of each of the tensors stacked on the first
    ``lead`` axes, kept broadcastable against ``x``."""
    n = x.dim() - lead
    if n <= 1:
        dims = tuple(range(lead, x.dim()))
    elif n in (2, 3):
        dims = (lead + 1,)
    elif n == 4:
        dims = (lead + 1, lead + 2, lead + 3)
    else:
        dims = tuple(range(lead + 1, x.dim()))
    return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))


def ranger21_lr_schedule(
    learning_rate: float,
    num_iterations: int,
    use_warmup: bool,
    warmdown_active: bool,
    beta2: float = 0.999,
    num_warmup_iterations: Optional[int] = None,
    warmdown_start_pct: float = 0.72,
    warmdown_min_lr: float = 3e-5,
) -> Callable[[int], float]:
    """The warmup/warmdown LR at a 1-based step, with the pinned package's
    quirks: auto warmup is ``ceil(2/(1-beta2))`` steps unless that exceeds
    45 % of training, then ``int(0.22*total)``; warmdown starts at
    ``int(pct*total)``, runs as ``(step+1-start)/(total-start+1)`` and
    overrides the warmup-dampened rate."""
    if use_warmup:
        if num_warmup_iterations is None:
            beta_based = math.ceil(2.0 / (1.0 - beta2))
            warmup_iters = (int(0.22 * num_iterations)
                            if beta_based / num_iterations > 0.45 else beta_based)
        else:
            warmup_iters = num_warmup_iterations
        warmup_iters = max(warmup_iters, 1)
    else:
        warmup_iters = 0
    warmdown_start = int(warmdown_start_pct * num_iterations)

    def lr_at(step: int) -> float:
        lr = float(learning_rate)
        if use_warmup and warmup_iters > 0:
            lr = lr * min(1.0, step / warmup_iters)
        if warmdown_active and step >= warmdown_start:
            total_down = num_iterations - warmdown_start
            wd_iter = max(step + 1.0 - warmdown_start, 1.0)
            pct = min(wd_iter / (total_down + 1), 1.0)
            lr = max(learning_rate - pct * (learning_rate - warmdown_min_lr), warmdown_min_lr)
        return lr

    return lr_at


class Ranger21(torch.optim.Optimizer):
    """Ranger21; ``num_iterations`` is the run's total number of steps."""

    def __init__(
        self,
        params,
        lr: float,
        *,
        num_iterations: int,
        weight_decay: float = 1e-4,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        use_warmup: bool = True,
        num_warmup_iterations: Optional[int] = None,
        warmdown_active: bool = True,
        warmdown_start_pct: float = 0.72,
        warmdown_min_lr: float = 3e-5,
        use_adaptive_gradient_clipping: bool = True,
        agc_clipping_value: float = 1e-2,
        agc_eps: float = 1e-3,
        using_gc: bool = True,
        normloss_active: bool = True,
        normloss_factor: float = 1e-4,
        use_softplus: bool = True,
        beta_softplus: float = 50.0,
        pnm_momentum_factor: float = 1.0,
        lookahead_active: bool = True,
        lookahead_mergetime: int = 5,
        lookahead_blending_alpha: float = 0.5,
        stable_decay_max_fraction: Optional[float] = None,
    ):
        super().__init__(params, dict(lr=lr, direction_stacked=False, update_scale=1.0))
        self.hp = dict(
            weight_decay=weight_decay, beta1=betas[0], beta2=betas[1], eps=eps,
            agc=use_adaptive_gradient_clipping, agc_clip=agc_clipping_value, agc_eps=agc_eps,
            gc=using_gc, normloss=normloss_active, normloss_factor=normloss_factor,
            softplus=use_softplus, beta_softplus=beta_softplus, pnm=pnm_momentum_factor,
            lookahead=lookahead_active, k=lookahead_mergetime, alpha=lookahead_blending_alpha,
            max_decay=stable_decay_max_fraction,
        )
        self.lr_at = ranger21_lr_schedule(
            lr, num_iterations, use_warmup, warmdown_active, beta2=betas[1],
            num_warmup_iterations=num_warmup_iterations,
            warmdown_start_pct=warmdown_start_pct, warmdown_min_lr=warmdown_min_lr,
        )
        self.count = 0

    def state_dict(self) -> dict:
        """The optimizer's state with its step count, which sets the warmup,
        the bias corrections and which moment a step updates."""
        state = super().state_dict()
        state["count"] = self.count
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = state_dict.pop("count")
        super().load_state_dict(state_dict)
        self.count = int(count)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        hp = self.hp
        self.count += 1
        step = self.count
        odd = step % 2 == 1
        b1sq = hp["beta1"] ** 2
        beta2 = hp["beta2"]

        # phase 1: clipped, centralised gradients, the moments, and the
        # pooled second moment for stable weight decay
        entries = []
        var_sum, n_elems = None, 0
        for group in self.param_groups:
            lead = 1 if group["direction_stacked"] else 0
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = g.to(torch.promote_types(p.dtype, torch.float32))
                p32 = p.to(g.dtype)
                if hp["agc"]:
                    p_norm = _unit_norm(p32, lead).clamp_min(hp["agc_eps"])
                    g_norm = _unit_norm(g, lead)
                    max_norm = p_norm * hp["agc_clip"]
                    g = torch.where(g_norm > max_norm, g * (max_norm / g_norm.clamp_min(1e-6)), g)
                if hp["gc"] and g.dim() - lead > 1:
                    g = g - g.mean(dim=tuple(range(lead + 1, g.dim())), keepdim=True)
                st = self.state[p]
                if not st:
                    st["grad_ma"] = torch.zeros_like(g)
                    st["neg_grad_ma"] = torch.zeros_like(g)
                    st["variance_ma"] = torch.zeros_like(g)
                    if hp["lookahead"]:
                        st["slow"] = p32.clone()
                ma = st["grad_ma"] if odd else st["neg_grad_ma"]
                ma.mul_(b1sq).add_(g, alpha=1.0 - b1sq)
                st["variance_ma"].mul_(beta2).add_(g * g, alpha=1.0 - beta2)
                v = st["variance_ma"].sum()
                var_sum = v if var_sum is None else var_sum + v
                n_elems += p.numel()
                entries.append((group, lead, p, p32, st))
        if not entries:
            return loss

        bias_c1 = 1.0 - hp["beta1"] ** step
        bias_c2 = 1.0 - beta2 ** step
        variance_normalized = torch.sqrt(var_sum / bias_c2 / n_elems).clamp_min(1e-12)
        lr = self.lr_at(step)
        noise_norm = math.sqrt((1.0 + beta2) ** 2 + beta2 ** 2)
        decay_fraction = hp["weight_decay"] * lr / variance_normalized
        if hp["max_decay"] is not None:
            decay_fraction = decay_fraction.clamp_max(hp["max_decay"])
        sync = hp["lookahead"] and step % hp["k"] == 0

        # phase 2: the parameter updates
        for group, lead, p, p32, st in entries:
            new_p = p32
            if hp["weight_decay"] > 0.0:
                new_p = new_p * (1.0 - decay_fraction)
            if hp["normloss"]:
                unorm = _unit_norm(new_p, lead)
                correction = 2.0 * hp["normloss_factor"] * (1.0 - 1.0 / (unorm + hp["eps"]))
                new_p = new_p * (1.0 - lr * correction)
            m_cur = st["grad_ma"] if odd else st["neg_grad_ma"]
            m_prev = st["neg_grad_ma"] if odd else st["grad_ma"]
            pn_momentum = ((1.0 + hp["pnm"]) * m_cur - hp["pnm"] * m_prev) / noise_norm
            denom = torch.sqrt(st["variance_ma"] / bias_c2) + hp["eps"]
            if hp["softplus"]:
                denom = F.softplus(denom, beta=hp["beta_softplus"])
            new_p = new_p - (lr / bias_c1) * pn_momentum / denom
            if sync:
                new_p = st["slow"] + hp["alpha"] * (new_p - st["slow"])
                st["slow"].copy_(new_p)
            p.add_(((new_p - p32) * group["update_scale"]).to(p.dtype))
        return loss
