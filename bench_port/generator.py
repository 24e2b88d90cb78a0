"""The one traffic generator: a configuration's sources, a traffic mix's
parameters and a seed give every stream's packets (and, in a lossy mix,
which packets are lost).

Each stream is one of the configuration's sources, looped: the source's
packets repeated back to back, the pre-skip kept on the first copy only
(the looping of the port's bench, esp32_opus_player_tpu_torch/bench.py::
looped, copied). A stream joins the looped source at a start packet, so
a stream with start > 0 has no pre-skip at all. Every seed has the same
streams: equal shares of the configuration's sources, each share's start
packets spread evenly over its source; the seed deals them to the rows
and draws the compared sample, so every seed is the same work in another
arrangement. Loss, where the mix has it:
per stream a two-state (Gilbert) chain with the mix's loss rate and mean
run of lost packets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import oggopus


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator from any whole-number seed (also past 2**63 or below 0)
    and a sub-stream index."""
    words = [(int(seed) >> (32 * i)) & 0xFFFFFFFF for i in range(3)]
    return np.random.default_rng(np.random.SeedSequence(words + [stream]))


@dataclass
class Plan:
    names: list             # source names
    paths: list             # their files
    sources: list           # their oggopus.OpusSource
    src: np.ndarray         # (B,) source index of each stream
    start: np.ndarray       # (B,) start packet in its source
    length: int             # packets a stream has
    compare: list           # stream indices the comparison reads
    lost: np.ndarray | None     # (B, length) bool, or None
    fec: bool               # a lost packet may take the next one's LBRR

    def packets(self, i: int) -> list:
        """Stream i's packets."""
        s = self.sources[self.src[i]]
        n = len(s.packets)
        return [s.packets[(int(self.start[i]) + k) % n]
                for k in range(self.length)]

    def discard(self, i: int) -> list:
        """Samples dropped from the front of each of stream i's first
        packets (the pre-skip, only where the stream starts at packet 0)."""
        if self.start[i] != 0:
            return []
        out, left = [], self.sources[self.src[i]].pre_skip
        while left > 0:
            out.append(min(left, 960))
            left -= out[-1]
        return out


def stream_length(traffic: dict, seconds: float) -> int:
    """Packets a stream needs: the warm-up; the window at the mix's highest
    expected step rate, rounded up to whole K-frame windows (the window
    ends on one); and the pipeline."""
    k = int(traffic["superstep_k"])
    window = math.ceil(seconds * traffic["max_steps_per_s"] / k) * k
    return int(traffic["warm_steps"]) + window + max(2, k) + k + 8


def gilbert_loss(rng, n: int, length: int, rate: float,
                 mean_burst: float) -> np.ndarray:
    """(n, length) bool: packets lost by a two-state chain whose lost
    runs last mean_burst packets on average and whose stationary loss
    share is `rate`; each stream starts in the stationary state."""
    p_bg = 1.0 / mean_burst                       # bad -> good
    p_gb = rate * p_bg / (1.0 - rate)             # good -> bad
    lost = np.zeros((n, length), dtype=bool)
    bad = rng.random(n) < rate
    for k in range(length):
        lost[:, k] = bad
        u = rng.random(n)
        bad = np.where(bad, u >= p_bg, u < p_gb)
    return lost


def plan(config: dict, traffic: dict, seed: int, seconds: float,
         root, length: int | None = None) -> Plan:
    """The streams of a run of `seconds` (or of `length` packets each)."""
    import pathlib
    root = pathlib.Path(root)
    B = int(traffic["streams"])
    names = [pathlib.Path(p).stem for p in config["sources"]]
    paths = [root / p for p in config["sources"]]
    sources = [oggopus.parse(p.read_bytes()) for p in paths]
    rng = rng_for(seed)
    # the same streams for every seed: equal shares of the sources, each
    # share's start packets spread evenly over its source; the seed
    # deals them to the rows
    share = np.arange(B) * len(sources) // B
    start = np.zeros(B, dtype=np.int64)
    for s in range(len(sources)):
        rows = np.nonzero(share == s)[0]
        start[rows] = np.arange(len(rows)) * len(sources[s].packets) \
            // len(rows)
    order = rng.permutation(B)
    src, start = share[order], start[order]
    k = min(int(traffic["compare_streams"]), B)
    bounds = np.linspace(0, B, k + 1).astype(int)
    compare = sorted(int(rng.integers(lo, hi))
                     for lo, hi in zip(bounds[:-1], bounds[1:]))
    if length is None:
        length = stream_length(traffic, seconds)
    loss = traffic.get("loss")
    lost = None
    if loss:
        lost = gilbert_loss(rng_for(seed, 1), B, length, loss["rate"],
                            loss["mean_burst"])
        lost[:, :int(loss.get("clean_head", 0))] = False
    return Plan(names=names, paths=paths, sources=sources, src=src,
                start=start, length=length, compare=compare, lost=lost,
                fec=bool(loss and loss.get("fec")))
