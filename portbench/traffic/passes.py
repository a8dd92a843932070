"""Traffic kind ``passes``: full top-n serving passes for every rated
user, back to back, through ``eval/recommend.recommend_all`` (the pass
behind ``recommend --all``), lists brought to the host.

Set-up makes the ratings and the factors on the device from the seed
(the generator's planted factors widened to the configuration's rank with
small seeded noise: scores with a trained model's structure), hands the
factors to the port through ``models/base.state_from_numpy``, builds the
serving layout (``ops/layout.build_blocked_csr``, as the command does)
and the rated bits (``build_rated_bits``) once, and runs one pass.

Every pass of the window keeps the lists of a sample of users drawn from
the seed (and the heaviest users, whose masks are longest); after the
window the plain reference judges each distinct list it kept.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.gen import ratings as gen
from portbench.reference import topn as ref_topn


class Run:
    def __init__(self, spec, seed: int, device, phases, tracing: bool):
        self.spec, self.seed, self.device, self.ph = spec, seed, device, phases
        self.c, self.mix = spec.config, spec.mix

    def setup(self):
        from ycnr_tpu_torch.eval.recommend import build_rated_bits
        from ycnr_tpu_torch.models.base import state_from_numpy
        from ycnr_tpu_torch.ops.layout import build_blocked_csr

        c, dev, ph, mix = self.c, self.device, self.ph, self.mix
        d = self.data = gen.make_for(c, self.seed, dev)
        nu, ni, k = d.n_users, d.n_items, c["rank"]
        ph.mark("generate")
        self.U = gen.served_factors(d.P, k, mix["factor_noise"], self.seed,
                                    dev, 3)
        self.V = gen.served_factors(d.Q, k, mix["factor_noise"], self.seed,
                                    dev, 4)
        tu = d.train_u.cpu().numpy().astype(np.int32)
        ti = d.train_i.cpu().numpy().astype(np.int32)
        tr = d.train_r.cpu().numpy()
        self.state = state_from_numpy(self.U.cpu().numpy(),
                                      self.V.cpu().numpy(),
                                      np.zeros(nu + 1), np.zeros(ni + 1),
                                      0.0, device=dev)
        ph.mark("factors and to host")
        self.layout = build_blocked_csr(tu, ti, tr, nu, ni, rank_hint=k)
        ph.mark("serving layout (host)")
        self.bits = build_rated_bits(self.layout, ni)
        ph.mark("rated bits (host)")
        users, items, scores = self._pass()
        ph.mark("first pass")
        rng = np.random.default_rng(self.seed)
        deg = np.bincount(tu, minlength=nu)[users]
        pick = rng.choice(len(users), min(mix["sample_users"], len(users)),
                          replace=False)
        heavy = np.argsort(-deg, kind="stable")[:mix["heavy_users"]]
        self.sample = np.unique(np.concatenate([pick, heavy]))
        self.users = users
        self.kept = []
        self.lengths = set()
        self.counts = {"users": int(len(users)), "n_items": ni, "rank": k,
                       "n": mix["n"],
                       "bits_words": int(self.bits.shape[-1])}

    def _pass(self):
        from ycnr_tpu_torch.eval.recommend import recommend_all

        return recommend_all(self.state, self.layout, n=self.mix["n"],
                             rated_bits=self.bits, method=self.mix["method"])

    def _passes(self, seconds: float) -> tuple:
        from ycnr_tpu_torch.ops.fused_topn import NEG_INF

        n = served = 0
        t0 = time.perf_counter()
        while True:
            users, items, scores = self._pass()
            served += len(users)
            self.lengths.add(len(users))
            n += 1
            t = time.perf_counter()
            s = self.sample
            self.kept.append((users[s], np.where(scores[s] > NEG_INF / 2,
                                                 items[s], -1)))
            if t - t0 >= seconds:
                break
        return n, served, t - t0

    def window(self, seconds: float) -> dict:
        """The passes of the window run under the device trace: the
        kernels' time a pass is the cell's end-to-end metric. The rated
        bits' upload from pageable memory, paced by the host, is left
        out of it and stays in ``recs_per_s``, a per-layer metric."""
        (n, served, t), kernel_s = harness.kernel_seconds(
            lambda: self._passes(seconds), self.device)
        self.recs_per_s = served / t
        harness.log(f"window: {n} passes, {served} lists in {t:.4f} s, "
                    f"kernels {kernel_s:.4f} s")
        return {"metrics": {"pass_kernel_ms": 1e3 * kernel_s / n},
                "attempted": n, "failed": 0}

    def trace(self) -> SimpleNamespace:
        (n, served, t), tr = harness.traced(
            lambda: self._passes(self.mix["trace_seconds"]),
            self.device)
        harness.log(f"traced: {n} passes in {t:.4f} s")
        return SimpleNamespace(trace=tr, config=self.c, counts=self.counts,
                               units=n, traced_wall_s=t, stats=None,
                               recs_per_s=self.recs_per_s)

    def release(self):
        del self.state, self.layout, self.bits
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def _distinct(self, kept):
        users = np.concatenate([u for u, _ in kept])
        lists = np.concatenate([x for _, x in kept]).astype(np.int64)
        both = np.unique(np.concatenate([users[:, None], lists], 1), axis=0)
        dev = self.device
        return (torch.as_tensor(both[:, 0], device=dev),
                torch.as_tensor(both[:, 1:], device=dev))

    def readings(self, kept) -> dict:
        d = self.data
        users, lists = self._distinct(kept)
        index = ref_topn.rated_index(d.train_u, d.train_i)
        r = ref_topn.check_lists(self.U, self.V, users, lists,
                                 self.mix["n"], index)
        harness.log(f"check: {r}")
        # every rated user is served in every pass
        rated = int(torch.unique(d.train_u).numel())
        missing = max(abs(n - rated) for n in self.lengths | {rated})
        return {"served_gap": r["gap"],
                "wrong_lists": r["rated"] + r["unknown"] + r["dup"]
                + r["short"] + missing}

    def check(self) -> dict:
        return self.readings(self.kept)

    def control_readings(self) -> dict:
        d = self.data
        users = torch.as_tensor(self.users[self.sample], device=self.device)
        index = ref_topn.rated_index(d.train_u, d.train_i)
        lists = ref_topn.top_lists(self.U, self.V, users, self.mix["n"],
                                   index, self.spec.cell["control"])
        return self.readings([(users.cpu().numpy(), lists.cpu().numpy())])
