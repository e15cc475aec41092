"""Open loop: independent users, requests sent on a schedule whether or
not earlier ones have finished, at a fixed rate.

Parameters (the workload file's `traffic`): `rate_per_s`, `lead_in_s`,
`prompt` and `output` length distributions (lengths.py), and
`schedule_seed`. The lead-in and the window each get their own schedule:
round(rate * span) requests whose gaps are an exponential's quantiles
scaled to the span, lengths from the mix's quantiles, put in an order
drawn from `schedule_seed`: one fixed draw of a Poisson process and of the
lengths, the same in every run. The run's seed draws the prompts' token
ids (and, in weights/, the weights): every seed offers the same work.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic.lengths import exponential_gaps, prompt_ids, quantiles


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int, seconds: float):
        self.lead_in = float(params["lead_in_s"])
        rate = float(params["rate_per_s"])
        order = np.random.default_rng(int(params["schedule_seed"]))
        rng = np.random.default_rng(int(seed))
        self.schedule = []
        for t0, span in ((0.0, self.lead_in), (self.lead_in, float(seconds))):
            n = max(1, round(rate * span))
            gaps = order.permutation(exponential_gaps(rate, n, span))
            due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            prompts = order.permutation(quantiles(params["prompt"], n))
            outs = order.permutation(quantiles(params["output"], n))
            for d, p, o in zip(due, prompts, outs):
                self.schedule.append(dict(id=len(self.schedule), due=float(d),
                                          prompt=prompt_ids(rng, int(p), vocab),
                                          max_new=int(o)))
        self._next = 0

    def pop_due(self, rel: float) -> list:
        """The requests due by `rel` seconds after the traffic's start."""
        out = []
        while self._next < len(self.schedule) and self.schedule[self._next]["due"] <= rel:
            out.append(self.schedule[self._next])
            self._next += 1
        return out

    def next_due(self) -> float:
        if self._next < len(self.schedule):
            return self.schedule[self._next]["due"]
        return float("inf")

    def on_finish(self, rid: int, rel: float) -> None:
        """An open loop sends on its schedule alone."""
