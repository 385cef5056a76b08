"""The traffic generator and the occupancy stamp."""

import collections

import numpy as np
import pytest
import torch

import tiny
from benchlib.config import load_json, model_settings
from benchlib.stamp import Stamp
from benchlib.traffic import Stream
from benchref.parser import HeuristicParser

SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_same_seed_gives_the_same_samples(seed):
    cfg = tiny.config()
    a, b = Stream(tiny.mix(), cfg, seed, model_settings(cfg)), Stream(tiny.mix(), cfg, seed, model_settings(cfg))
    assert a.specs == b.specs
    for x, y in zip(a.samples, b.samples):
        assert np.array_equal(x.image_canonical, y.image_canonical) and np.array_equal(x.gt_mask, y.gt_mask)
        assert np.array_equal(x.image_1024, y.image_1024) and x.sentences == y.sentences


def test_every_seed_gets_the_same_work_in_the_same_order():
    mix, cfg = load_json("benchmark/traffic/refcoco-occupancy.json"), load_json(
        "benchmark/configs/refcoco-samh-clipb16.json")
    cfg = dict(cfg, images=dict(cfg["images"]))
    multisets = set()
    for seed in SEEDS[:3]:
        s = Stream(dict(mix, cycle=64), cfg, seed, model_settings(cfg))
        multisets.add(tuple((s.sizes[x.size], x.n_expr, x.live) for x in s.specs))
        assert np.mean([x.n_expr for x in s.specs]) == pytest.approx(2.84, abs=0.01)
    assert len(multisets) == 1


def test_expressions_cover_the_parser_flags():
    cfg, mix = tiny.config(), dict(tiny.mix(), cycle=64, expressions_per_sample={"4": 64})
    parser = HeuristicParser()
    seen = collections.Counter()
    for seed in (1, 2):
        for s in Stream(mix, cfg, seed, model_settings(cfg)).samples:
            for sent in s.sentences:
                p = parser.parse(sent)
                seen[("dir", p.dir_flag)] += 1
                seen[("rela", p.rela_flag)] += 1
                seen[("others", min(len(p.other_noun_phrases), 2))] += 1
    for key in [("dir", f) for f in ("left", "right", "middle", "up", "down", "none")] + \
               [("rela", f) for f in ("left", "up", "down", "big", "small", "within", "none")] + \
               [("others", n) for n in (0, 1, 2)]:
        assert seen[key] > 0, key


class Props:
    def __init__(self, P, C, num):
        self.masks = torch.zeros(P, C, C, dtype=torch.bool)
        self.boxes_xyxy = torch.zeros(P, 4)
        self.num = num

    def _replace(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        return self


def test_stamp_sets_host_validity_and_the_pattern_buckets():
    from benchlib.traffic import _next_pow2

    pattern = [21, 7, 33, 12, 48, 3, 17, 26]
    stamp = Stamp([(480, 640), (640, 427)], 640, 64, len(pattern), "cpu", 5)
    buckets = []
    for pos, live in enumerate(pattern):
        props = stamp(Props(64, 640, 1), type("S", (), {"live": live, "size": pos % 2})(), pos)
        assert props.num == live and props.valid.device.type == "cpu"
        assert props.valid.tolist() == [i < live for i in range(64)]
        assert bool(props.masks[1:live].flatten(1).any(1).all()) and not bool(props.masks[live:].any())
        assert bool((props.boxes_xyxy[1:live, 2:] >= props.boxes_xyxy[1:live, :2]).all())
        buckets.append(_next_pow2(int(np.nonzero(props.valid.numpy())[0][-1]) + 1, 8))
    assert buckets == [32, 8, 64, 16, 64, 8, 32, 32]
