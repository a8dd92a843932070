"""Traffic kind ``epochs``: whole training epochs of the port's bucketed
ALS-WR / iALS back to back, as ``train()`` builds them on one card.

Set-up makes the ratings and the start factors on the device from the
seed, builds the layouts with ``ops/bucketed.build_bucketed`` on the host
and uploads them with ``device_bucketed``, zeroes the cold rows as
``train()`` does, and drives the epoch function through its first
``checked_epochs`` epochs (which also warm every shape). The window then
runs the same epoch function on the same state until ``--seconds`` have
passed; each epoch ends in a device synchronize, as in ``train()``.

The check (after the window, the program's layouts freed): the plain
reference follows the first epochs from the same start, and repeats the
window's last epoch from the item table it started from; the factors
(worst row) and the held-out RMSE are compared.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.gen import ratings as gen
from portbench.reference import mf


def _host(x, dtype):
    return x.cpu().numpy().astype(dtype, copy=False)


class Run:
    def __init__(self, spec, seed: int, device, phases, tracing: bool):
        self.spec, self.seed, self.device, self.ph = spec, seed, device, phases
        self.c = spec.config

    def setup(self):
        import ycnr_tpu_torch.models.bucketed_phase as bp
        import ycnr_tpu_torch.ops.bucketed as bk
        from ycnr_tpu_torch.models.base import (rmse_padded,
                                                state_from_numpy,
                                                zero_cold_entities)
        from ycnr_tpu_torch.ops.layout import pad_coo

        c, dev, ph = self.c, self.device, self.ph
        d = self.data = gen.make_for(c, self.seed, dev)
        nu, ni, k = d.n_users, d.n_items, c["rank"]
        ph.mark("generate")
        tu, ti = _host(d.train_u, np.int32), _host(d.train_i, np.int32)
        tr = _host(d.train_r, np.float32)
        ph.mark("to host")
        ul = bk.build_bucketed(tu, ti, tr, nu, ni, c["chunk_len"], k,
                               max_groups=c["max_groups"])
        il = bk.build_bucketed(ti, tu, tr, ni, nu, c["chunk_len"], k,
                               max_groups=c["max_groups"])
        ph.mark("layouts (host)")
        bf16 = c["gather"] == "bfloat16"
        alpha = c.get("alpha")
        rdt = (torch.bfloat16 if bp.uses_fused(dev, torch.float32, alpha,
                                               bf16, k) else torch.float32)
        self.dul = bp.device_bucketed(ul, torch.float32, dev, rdt)
        self.dil = bp.device_bucketed(il, torch.float32, dev, rdt)
        del ul, il
        ph.mark("layouts (upload)")
        self.U0 = gen.start_factors(nu, k, c["init_scale"], self.seed, dev, 1)
        self.V0 = gen.start_factors(ni, k, c["init_scale"], self.seed, dev, 2)
        st = state_from_numpy(self.U0.cpu().numpy(), self.V0.cpu().numpy(),
                              np.zeros(nu + 1), np.zeros(ni + 1), 0.0,
                              device=dev)
        st = zero_cold_entities(st, tu, ti)
        if alpha is None:
            self.epoch_fn = bp.als_epoch_fn(self.dul, self.dil, c["lam"],
                                            bf16)
        else:
            self.epoch_fn = bp.ials_epoch_fn(self.dul, self.dil, c["lam"],
                                             alpha, bf16)
        pu, pi, pr, n = pad_coo(_host(d.test_u, np.int32),
                                _host(d.test_i, np.int32),
                                _host(d.test_r, np.float32), nu, ni, 8192)
        self.test = tuple(torch.as_tensor(x, device=dev)
                          for x in (pu, pi, pr)) + (n,)
        self.rmse = lambda s: float(rmse_padded(s, *self.test))
        ph.mark("state")
        self.start = []
        for _ in range(self.spec.mix["checked_epochs"]):
            st = self.epoch_fn(st)
            harness.sync(dev)
            self.start.append((st.U.clone(), st.V.clone(), self.rmse(st)))
        ph.mark("checked epochs")
        self.state = st
        self.V_prev = torch.empty_like(st.V)
        self.counts = {
            "nnz": int(d.train_u.numel()), "n_users": nu, "n_items": ni,
            "users": int(torch.unique(d.train_u).numel()),
            "items": int(torch.unique(d.train_i).numel()), "rank": k}

    def _epochs(self, seconds: float) -> tuple:
        """Epochs until ``seconds`` have passed: (count, seconds)."""
        st, fn, Vp, dev = self.state, self.epoch_fn, self.V_prev, self.device
        n, t0 = 0, time.perf_counter()
        while True:
            Vp.copy_(st.V)  # the window's last epoch is checked from it
            st = fn(st)
            harness.sync(dev)
            n += 1
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        self.state = st
        return n, t - t0

    def window(self, seconds: float) -> dict:
        n, t = self._epochs(seconds)
        self.epoch_ms = 1e3 * t / n
        harness.log(f"window: {n} epochs in {t:.4f} s")
        return {"metrics": {"epoch_ms": self.epoch_ms}, "attempted": n,
                "failed": 0}

    def trace(self) -> SimpleNamespace:
        (n, t), tr = harness.traced(
            lambda: self._epochs(self.spec.mix["trace_seconds"]),
            self.device)
        harness.log(f"traced: {n} epochs in {t:.4f} s")
        return SimpleNamespace(trace=tr, config=self.c, counts=self.counts,
                               units=n, epoch_ms=self.epoch_ms,
                               traced_wall_s=t, stats=None)

    def release(self):
        st = self.state
        self.final = (st.U, st.V, self.rmse(st))
        del self.dul, self.dil, self.epoch_fn, self.state
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def _ref(self):
        d = self.data
        ref = harness.load_module(os.path.join(harness.HERE, "reference",
                                               self.c["reference"]))
        lu = mf.entity_lists(d.train_u, d.train_i, d.train_r, d.n_users,
                             d.n_items)
        li = mf.entity_lists(d.train_i, d.train_u, d.train_r, d.n_items,
                             d.n_users)
        return ref, lu, li

    def _rmse(self, U, V) -> float:
        d = self.data
        return mf.rmse(U, V, d.test_u, d.test_i, d.test_r)

    def outputs(self, gather: str, lists=None) -> dict:
        """What the reference computes in the program's place, with rows
        gathered in ``gather`` (the control) or from other ``lists`` (a
        planted fault): the checked start and the window's last epoch."""
        ref, lu, li = self._ref()
        if lists is not None:
            lu, li = lists
        V = mf.zero_cold(self.V0, li.counts)
        start = []
        for _ in self.start:
            U, V = ref.epoch(V, lu, li, self.c, gather)
            start.append((U, V, self._rmse(U, V)))
        U, V = ref.epoch(self.V_prev, lu, li, self.c, gather)
        return {"start": start, "final": (U, V, self._rmse(U, V))}

    def readings(self, prog: dict) -> dict:
        want = self.outputs(self.c["gather"])

        def gaps(p, r):
            return (max(mf.row_gap(p[0], r[0]), mf.row_gap(p[1], r[1])),
                    abs(p[2] - r[2]))

        start = [gaps(p, r) for p, r in zip(prog["start"], want["start"])]
        last = gaps(prog["final"], want["final"])
        out = {"start_factor_gap": max(g for g, _ in start),
               "window_factor_gap": last[0],
               "rmse_gap": max([r for _, r in start] + [last[1]])}
        harness.log("check: " + ", ".join(
            f"epoch {j + 1} factors {g:.3e} rmse {r:.3e}"
            for j, (g, r) in enumerate(start))
            + f"; last window epoch factors {last[0]:.3e} rmse {last[1]:.3e}"
            f" (rmse {prog['final'][2]:.6f} vs {want['final'][2]:.6f})")
        return out

    def check(self) -> dict:
        return self.readings({"start": self.start, "final": self.final})

    def control_readings(self) -> dict:
        return self.readings(self.outputs(self.c["control_gather"]))

    def fault_readings(self) -> dict:
        """The reference put in the program's place with each fault that
        a training cell can have, planted: half of each epoch's ratings
        left out; one answer (the heaviest user's row) altered."""
        d = self.data
        g = gen.generator(self.seed, self.device, 9)
        keep = torch.rand(d.train_u.numel(), generator=g,
                          device=self.device) < 0.5
        half = (mf.entity_lists(d.train_u[keep], d.train_i[keep],
                                d.train_r[keep], d.n_users, d.n_items),
                mf.entity_lists(d.train_i[keep], d.train_u[keep],
                                d.train_r[keep], d.n_items, d.n_users))
        out = {"half_batch": self.readings(self.outputs(self.c["gather"],
                                                        half))}
        _, lu, _ = self._ref()
        heavy = int(torch.argmax(lu.counts))
        other = int(torch.argsort(lu.counts)[-2])
        U, V, r = self.final
        U = U.clone()
        U[heavy] = U[other]
        out["answer_altered"] = self.readings(
            {"start": self.start, "final": (U, V, r)})
        return out
