"""The one traffic generator: a closed stream of referring samples from a
traffic mix (``traffic/<name>.json``), a configuration and the seed.

A mix fixes a cycle of sample specs, the same for every seed and in the same
order: the image sizes (the configuration's ``images`` range on a fixed grid,
taken in turn), the expressions per sample (``expressions_per_sample``: count
-> samples in a cycle, interleaved) and, where the mix stamps occupancy, the
live proposals per image (``live_proposals``, repeated over the cycle). The
seed draws the content: the pictures, the referred regions, the words. (An
order drawn from the seed moved the 95th percentile of the latency by 6%
between seeds: the tail is set by the heaviest images' neighbours.)
The stream repeats the cycle for as long as the window lasts.

Keys of a mix: ``cycle``, ``expressions_per_sample``, ``other_nouns`` (the
chance of 0, 1, 2 ... other nouns in an expression), ``live_proposals``
(a list, or null for no stamp), ``stamp_pool`` (regions a size in the
stamp's pool), ``warm_buckets`` (without a stamp: the larger proposal
buckets that an image's real survivors reach now and then, warmed up too),
``check_images`` (images the comparison checks), ``profile_images`` (images
of the traced tail).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .samples import Sample, build_image_sample, expression, scene


def _next_pow2(n: int, base: int = 1) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def image_sizes(images: dict) -> list:
    """The configuration's image sizes as (h, w), a fixed grid of ``sizes`` entries."""
    n = images["sizes"]
    out = []
    for k in range(n):
        q = (k + 0.5) / n
        if "aspect" in images:  # long side and aspect on a square grid
            side = int(round(n ** 0.5))
            a0, a1 = images["aspect"]
            l0, l1 = images["long_side"]
            long = int(round(l0 + (l1 - l0) * ((k // side) + 0.5) / side))
            short = int(round(long * (a0 + (a1 - a0) * ((k % side) + 0.5) / side)))
        else:
            long = images["long_side"][0]
            s0, s1 = images["short_side"]
            short = int(round(s0 + (s1 - s0) * q))
        portrait = (k % int(round(1 / images["portrait_share"]))) == 0
        out.append((long, short) if portrait else (short, long))
    return out


class Spec(NamedTuple):
    size: int  # index into the image sizes
    n_expr: int
    live: Optional[int]  # stamped live proposals, None without a stamp


class Stream:
    """The cycle of samples of one cell and seed: ``sample(i)`` for the i-th
    image of the stream, ``specs[i % cycle]`` its spec."""

    def __init__(self, mix: dict, cfg: dict, seed: int, settings):
        rng = np.random.default_rng(seed)
        n = mix["cycle"]
        self.sizes = image_sizes(cfg["images"])
        n_expr = [int(k) for k, c in sorted(mix["expressions_per_sample"].items()) for _ in range(c)]
        if len(n_expr) != n:
            raise ValueError("expressions_per_sample must count the whole cycle")
        pattern = mix.get("live_proposals")
        # the specs and their order are the mix's own: every seed gets the same work in the same order
        self.specs = [Spec(i % len(self.sizes), n_expr[(7 * i) % n], None if not pattern else pattern[i % len(pattern)])
                      for i in range(n)]
        others = sorted(mix["other_nouns"].items())
        p = np.array([float(v) for _, v in others])
        lo, hi = cfg["images"]["objects"]
        self.samples = []
        for spec in self.specs:
            h, w = self.sizes[spec.size]
            img, gt = scene(rng, h, w, int(rng.integers(lo, hi + 1)))
            sents = [expression(rng, int(others[rng.choice(len(others), p=p / p.sum())][0]))
                     for _ in range(spec.n_expr)]
            self.samples.append(build_image_sample(img, sents, gt, lambda im: settings.family.frame(settings.sam, im),
                                                   cfg["canonical_size"]))
        self.stamped = pattern is not None

    def __len__(self):
        return len(self.specs)

    def sample(self, i: int) -> Sample:
        return self.samples[i % len(self.samples)]._replace()

    def spec(self, i: int) -> Spec:
        return self.specs[i % len(self.specs)]

    def keys(self) -> list:
        """The (proposal bucket, sentence bucket) of each stamped spec, or
        (None, sentence bucket) without a stamp, first position of each."""
        seen = {}
        for i, s in enumerate(self.specs):
            key = (None if s.live is None else _next_pow2(s.live, 8), _next_pow2(s.n_expr))
            seen.setdefault(key, i)
        return sorted(seen.items(), key=lambda kv: kv[1])

    def checked(self, n: int, seed: int) -> set:
        """The positions of the first cycle the comparison checks, drawn from
        the seed, the one with the most stamped proposals always among them."""
        rng = np.random.default_rng(seed ^ 0x5EED)
        out = set(int(i) for i in rng.choice(len(self), min(n, len(self)), replace=False))
        if self.stamped:
            biggest = max(range(len(self)), key=lambda i: self.specs[i].live)
            if biggest not in out:
                out.discard(min(out))
                out.add(biggest)
        return out
