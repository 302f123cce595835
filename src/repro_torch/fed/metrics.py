"""Per-round federated diagnostics: honest loss, kappa-hat, participation
(counterpart of ``repro.fed.metrics``).

``FedHistory`` is the record a run appends to; it keeps scalars as plain
Python floats (on the host, after one transfer per segment) and exposes
the aggregate views the scenario reports need (participation counts per
client, per-attack-phase loss means).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# The kappa-hat estimator (paper Eq. 26) is shared with the lockstep
# trainer; re-exported here under the fed-facing name.
from repro_torch.core.theory import tree_kappa_hat as kappa_hat  # noqa: F401


@dataclasses.dataclass
class FedHistory:
    loss: list = dataclasses.field(default_factory=list)
    kappa_hat: list = dataclasses.field(default_factory=list)
    direction_norm: list = dataclasses.field(default_factory=list)
    lr: list = dataclasses.field(default_factory=list)
    attack: list = dataclasses.field(default_factory=list)
    eta: list = dataclasses.field(default_factory=list)
    cohorts: list = dataclasses.field(default_factory=list)   # np.ndarray per round
    m_byz: list = dataclasses.field(default_factory=list)
    f_round: list = dataclasses.field(default_factory=list)
    #: Health taps per round: {field: np.ndarray} when the round ran
    #: tapped, None otherwise (one entry per round).
    taps: list = dataclasses.field(default_factory=list)

    def record(self, metrics: dict, *, cohort: np.ndarray, attack: str,
               eta: Optional[float], m_byz: int, f_round: int,
               taps: Optional[dict] = None) -> None:
        self.loss.append(float(metrics["loss"]))
        self.direction_norm.append(float(metrics["direction_norm"]))
        self.lr.append(float(metrics["lr"]))
        # NaN placeholder when untracked: kappa_hat[i] must stay round i's
        # value even across runs that toggle tracking mid-history.
        self.kappa_hat.append(float(metrics["kappa_hat"])
                              if "kappa_hat" in metrics else float("nan"))
        self.attack.append(attack)
        self.eta.append(eta)
        self.cohorts.append(np.asarray(cohort))
        self.m_byz.append(m_byz)
        self.f_round.append(f_round)
        self.taps.append(None if taps is None else
                         {k: np.asarray(v) for k, v in taps.items()})

    @property
    def rounds(self) -> int:
        return len(self.loss)

    def participation_counts(self, n_clients: int) -> np.ndarray:
        """How many rounds each client was sampled into the cohort."""
        counts = np.zeros(n_clients, np.int64)
        for c in self.cohorts:
            counts[c] += 1
        return counts

    def attack_segments(self) -> list[tuple[str, int, int]]:
        """Contiguous (attack, start_round, end_round_exclusive) segments."""
        segs: list[tuple[str, int, int]] = []
        for r, a in enumerate(self.attack):
            if segs and segs[-1][0] == a:
                segs[-1] = (a, segs[-1][1], r + 1)
            else:
                segs.append((a, r, r + 1))
        return segs

    def tap_columns(self) -> dict:
        """Round-stacked tap columns ``{field: (rounds, ...) array}``.
        Empty when any round ran untapped (columns would misalign)."""
        if not self.taps or any(t is None for t in self.taps):
            return {}
        return {k: np.stack([t[k] for t in self.taps])
                for k in self.taps[0]}

    # -- persistence ------------------------------------------------------
    def pack(self) -> tuple[dict, dict]:
        """``(arrays, meta)`` snapshot form: numeric columns as arrays
        (bit-exact float64 of the recorded Python floats), attack/eta as
        JSON-able lists.  Inverse of :meth:`unpack`."""
        arrays = {
            "loss": np.asarray(self.loss, np.float64),
            "kappa_hat": np.asarray(self.kappa_hat, np.float64),
            "direction_norm": np.asarray(self.direction_norm, np.float64),
            "lr": np.asarray(self.lr, np.float64),
            "m_byz": np.asarray(self.m_byz, np.int64),
            "f_round": np.asarray(self.f_round, np.int64),
            "cohorts": (np.stack(self.cohorts) if self.cohorts
                        else np.zeros((0, 0), np.int32)),
        }
        tapped = [t is not None for t in self.taps]
        if any(tapped):
            if not all(tapped):
                raise ValueError(
                    "cannot pack a FedHistory with mixed tapped/untapped "
                    "rounds (tap columns would misalign)")
            for k in self.taps[0]:
                arrays[f"taps.{k}"] = np.stack([t[k] for t in self.taps])
        meta = {"attack": list(self.attack),
                "eta": [None if e is None else float(e) for e in self.eta]}
        return arrays, meta

    @classmethod
    def unpack(cls, arrays: dict, meta: dict) -> "FedHistory":
        h = cls()
        rounds = len(meta["attack"])
        h.loss = [float(x) for x in arrays["loss"]]
        h.kappa_hat = [float(x) for x in arrays["kappa_hat"]]
        h.direction_norm = [float(x) for x in arrays["direction_norm"]]
        h.lr = [float(x) for x in arrays["lr"]]
        h.m_byz = [int(x) for x in arrays["m_byz"]]
        h.f_round = [int(x) for x in arrays["f_round"]]
        h.cohorts = [np.asarray(arrays["cohorts"][r])
                     for r in range(rounds)]
        h.attack = list(meta["attack"])
        h.eta = [None if e is None else float(e) for e in meta["eta"]]
        tap_names = sorted(k[len("taps."):] for k in arrays
                           if k.startswith("taps."))
        if tap_names:
            h.taps = [{n: np.asarray(arrays[f"taps.{n}"][r])
                       for n in tap_names} for r in range(rounds)]
        else:
            h.taps = [None] * rounds
        return h

    def summary(self) -> dict:
        kappa = np.asarray(self.kappa_hat, np.float64)
        tracked = kappa[np.isfinite(kappa)]
        out = {
            "rounds": self.rounds,
            "final_loss": self.loss[-1] if self.loss else None,
            # nanmean over the tracked rounds (NaN = untracked placeholder).
            "mean_kappa_hat": (float(tracked.mean()) if tracked.size
                               else None),
            "attacks": [f"{a}[{s}:{e}]" for a, s, e in self.attack_segments()],
        }
        by_attack: dict[str, list] = {}
        for a, s, e in self.attack_segments():
            by_attack.setdefault(a, []).extend(self.loss[s:e])
        for a, losses in by_attack.items():
            out[f"loss_{a}"] = float(np.mean(losses))
        return out
