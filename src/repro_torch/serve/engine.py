"""Batched LM serving engine (continuous-batching lite).

The KV cache *is* the RedN distributed KV store: a decode step's attention
is a get against each sequence's cache, run where the cache lives.  The
engine also carries the paper's two operational properties:

* isolation (§5.5) — per-client token buckets gate admission, so one
  tenant hammering decode can't inflate another's tail latency;
* failure resiliency (§5.6) — all serving state (params, caches, slot
  table) lives in device tensors owned by this object; the host-side
  driver dict is disposable and a driver crash/restart leaves serving
  untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..models import model as model_lib
from ..rdma import isolation
from ..train.loop import make_serve_step


@dataclasses.dataclass
class ServeEngine:
    cfg: object
    params: object
    s_max: int
    n_slots: int
    n_clients: int = 4
    rate_per_us: float = 1.0
    burst: float = 8.0
    device: Optional[object] = None

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        self._serve = make_serve_step(self.cfg)
        self.caches = model_lib.init_cache(self.cfg, self.n_slots,
                                           self.s_max, self.device)
        self.lengths = torch.zeros(self.n_slots, dtype=torch.int32,
                                   device=self.device)
        # an encoder-decoder model's cross-attention reads its slot's
        # s_max encoder positions ('ck', 'cv'; zeros until set)
        self.enc_lengths = (torch.full((self.n_slots,), self.s_max,
                                       dtype=torch.int32, device=self.device)
                            if self.cfg.is_encdec else None)
        self.tokens = torch.zeros(self.n_slots, dtype=torch.int32,
                                  device=self.device)
        self.active = np.zeros((self.n_slots,), bool)
        self.slot_client = np.zeros((self.n_slots,), np.int32)
        self.buckets = isolation.init(self.n_clients, self.burst,
                                      self.device)
        self.clock_us = 0.0
        self.driver: Optional[Dict] = {"config": "serving", "alive": True}
        self.stats = dict(steps=0, tokens=0, throttled=0)

    # -- admission (isolation) ------------------------------------------------
    def admit(self, client_ids: List[int]) -> List[bool]:
        ids = torch.tensor(client_ids, dtype=torch.int64, device=self.device)
        self.buckets, ok = isolation.admit(
            self.buckets, ids, self.clock_us, self.rate_per_us, self.burst)
        ok = ok.cpu().numpy()
        self.stats["throttled"] += int((~ok).sum())
        return ok.tolist()

    def add_request(self, slot: int, client: int, first_token: int):
        self.active[slot] = True
        self.slot_client[slot] = client
        self.tokens[slot] = first_token
        self.lengths[slot] = 1

    # -- the decode tick ------------------------------------------------------
    def step(self) -> np.ndarray:
        """One decode tick for every slot (idle ones too, at length 0);
        returns the sampled (argmax) tokens."""
        logits, self.caches = self._serve(self.params, self.tokens,
                                          self.caches, self.lengths,
                                          self.enc_lengths)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tokens = nxt
        self.lengths = self.lengths + torch.from_numpy(
            self.active.astype(np.int32)).to(self.device)
        self.clock_us += 1.0
        self.stats["steps"] += 1
        self.stats["tokens"] += int(self.active.sum())
        return nxt.cpu().numpy()

    # -- failure resiliency ---------------------------------------------------
    def crash_host_driver(self):
        self.driver = None            # the Memcached process dies

    def restart_host_driver(self):
        self.driver = {"config": "serving", "alive": True}

    def host_alive(self) -> bool:
        return self.driver is not None
