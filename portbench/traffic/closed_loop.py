"""Closed loop: `clients` callers, each sending its next request the moment
its last one finishes (offline batch generation: evaluations, synthetic
data).

Parameters (the workload file's `traffic`): `clients`, `lead_in_s`,
`start_spread_s`, `prompt` and `output` length distributions (lengths.py),
`pool`, the number of request sizes in the fixed set that the clients take
in turn, and `schedule_seed`, which orders that set once for every run
(the run's seed draws the prompts' token ids). Client i starts at i * start_spread_s /
clients, so that the first admissions do not all land in one step; its
first request asks for a share (i + 0.5) / clients of its drawn output
length, as if it had been running already, so that completions are
spread from the start and the lead-in reaches a steady state sooner.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from portbench.traffic.lengths import prompt_ids, quantiles


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int, seconds: float):
        self.lead_in = float(params["lead_in_s"])
        self.clients = int(params["clients"])
        n = int(params["pool"])
        order = np.random.default_rng(int(params["schedule_seed"]))
        self.rng = np.random.default_rng(int(seed))
        self.vocab = vocab
        self.prompts = order.permutation(quantiles(params["prompt"], n))
        self.outs = order.permutation(quantiles(params["output"], n))
        self.taken = 0
        spread = float(params.get("start_spread_s", 0.0))
        self.ready = [(c * spread / self.clients, c) for c in range(self.clients)]
        self.owner = {}

    def _make(self, due: float, client: int) -> dict:
        i = self.taken % len(self.prompts)
        out = int(self.outs[i])
        if self.taken < self.clients:
            out = max(1, math.ceil(out * (client + 0.5) / self.clients))
        req = dict(id=self.taken, due=due,
                   prompt=prompt_ids(self.rng, int(self.prompts[i]), self.vocab),
                   max_new=out)
        self.owner[req["id"]] = client
        self.taken += 1
        return req

    def pop_due(self, rel: float) -> list:
        out = []
        while self.ready and self.ready[0][0] <= rel:
            due, client = heapq.heappop(self.ready)
            out.append(self._make(due, client))
        return out

    def next_due(self) -> float:
        return self.ready[0][0] if self.ready else float("inf")

    def on_finish(self, rid: int, rel: float) -> None:
        heapq.heappush(self.ready, (rel, self.owner.pop(rid)))
