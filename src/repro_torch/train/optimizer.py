"""AdamW with a float32 master copy, or with int8 moments and no master
(the JAX package's ``repro.train.optimizer``, name for name).

The state is an :class:`AdamWState` whose ``mu``, ``nu`` and ``master``
are dicts keyed by the model's parameter names (``named_parameters``, in
its order); an int8 moment is a dict ``{"q": int8, "s": float32}`` with
one scale per row of the last dim.  ``params`` is the model (an
``nn.Module``) or a dict of its named tensors.  :func:`update` writes the
new values into the parameters in place, which spares a second copy of
the weights, and returns them with a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor                    # () int32
    mu: Dict[str, Any]                    # float32, or int8 {"q", "s"}
    nu: Dict[str, Any]
    master: Optional[Dict[str, torch.Tensor]]   # float32 copy, or None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # memory tier: 'float32' moments + f32 master (default), or 'int8'
    # moments with per-row scales and, with master=False, no master
    moments_dtype: str = "float32"
    master: bool = True


def named(params) -> Dict[str, torch.Tensor]:
    """The parameters by name: a module's ``named_parameters``, or the
    dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _q8(x, sqrt_domain: bool = False):
    """Per-row (last-dim) symmetric int8 quantization: {'q', 's'}.

    sqrt_domain=True stores sqrt(x) (x >= 0), which widens int8's 127:1
    linear range to ~16000:1 on the value: Adam's second moment needs it
    (linear int8 rounds a small nu to 0 and mu / (sqrt(nu) + eps)
    explodes)."""
    xf = x.float()
    if sqrt_domain:
        xf = torch.sqrt(torch.clamp(xf, min=0.0))
    s = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    return {"q": torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8),
            "s": s}


def _dq8(m, sqrt_domain: bool = False):
    x = m["q"].float() * m["s"]
    return torch.square(x) if sqrt_domain else x


def init(params, cfg: Optional[AdamWConfig] = None) -> AdamWState:
    cfg = cfg or AdamWConfig()
    ps = named(params)
    device = next(iter(ps.values())).device
    step = torch.zeros((), dtype=torch.int32, device=device)
    with torch.no_grad():
        if cfg.moments_dtype == "int8":
            def zq(sd):
                return {n: _q8(torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), sqrt_domain=sd)
                        for n, p in ps.items()}
            master = ({n: p.float().clone() for n, p in ps.items()}
                      if cfg.master else None)
            return AdamWState(step=step, mu=zq(False), nu=zq(True),
                              master=master)
        return AdamWState(
            step=step,
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in ps.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in ps.items()},
            master={n: p.float().clone() for n, p in ps.items()})


def abstract_init(abstract_params,
                  cfg: Optional[AdamWConfig] = None) -> AdamWState:
    """The state's shapes and types on the meta device, no storage."""
    return init({n: torch.empty_like(p, device="meta")
                 for n, p in named(abstract_params).items()}, cfg)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: AdamWState, params) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW step: clip by the global norm, then the bias-corrected
    update with decoupled weight decay on the master (or, master-less, on
    the parameter in float32).  Writes the parameters, and the float32
    moments and master, in place (each operation rounds as its
    out-of-place form would: the same bits); returns (params, the state,
    {"grad_norm", "lr"}).  A functional update would hold the old and the
    new master and moments at once, 24 bytes a parameter, and a large
    tensor's temporaries beside them; in place, a step needs the state
    once and a few temporaries of its largest tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    quant = cfg.moments_dtype == "int8"
    eps = max(cfg.eps, 1e-6) if quant else cfg.eps
    mus, nus, masters = {}, {}, {}
    for name, p in named(params).items():
        g = grads[name].float() * scale
        mu, nu = state.mu[name], state.nu[name]
        if quant:
            mu, nu = _dq8(mu), _dq8(nu, sqrt_domain=True)
        m = (state.master[name] if state.master is not None
             else p.float())           # master-less: params carry the state
        # mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        # delta = mu_hat / (sqrt(nu_hat) + eps) + wd m;  m = m - lr delta
        delta = mu / (1 - cfg.b1 ** stepf)
        denom = nu / (1 - cfg.b2 ** stepf)
        delta.div_(denom.sqrt_().add_(eps)).add_(cfg.weight_decay * m)
        del denom
        m.sub_(delta.mul_(lr))
        del delta
        if quant:
            mu, nu = _q8(mu), _q8(nu, sqrt_domain=True)
        mus[name], nus[name], masters[name] = mu, nu, m
        p.copy_(m.to(p.dtype))
    master = masters if state.master is not None else None
    return params, AdamWState(step, mus, nus, master), {
        "grad_norm": gnorm, "lr": lr}
