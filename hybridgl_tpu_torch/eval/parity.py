"""The port's own copy of ``hybridgl_tpu/eval/parity.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

Per-ref-id selection parity harness.

Stronger than aggregate IoU (which can hide compensating errors): records
which proposal each (ref, sentence) selected so two runs — ours vs the
reference, or two of our builds — can be diffed sample by sample
(BASELINE.md protocol item 2).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List


@dataclass
class SelectionRecord:
    ref_id: int
    sentence: str
    pure_index: int
    final_index: int
    pure_iou: float
    final_iou: float


@dataclass
class ParityLog:
    meta: Dict = field(default_factory=dict)
    records: List[SelectionRecord] = field(default_factory=list)

    def add(self, rec: SelectionRecord) -> None:
        self.records.append(rec)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"meta": self.meta, "records": [asdict(r) for r in self.records]}, f
            )

    @staticmethod
    def load(path: str) -> "ParityLog":
        with open(path) as f:
            payload = json.load(f)
        log = ParityLog(meta=payload.get("meta", {}))
        for r in payload["records"]:
            log.add(SelectionRecord(**r))
        return log


def compare(a: ParityLog, b: ParityLog) -> Dict:
    """Selection agreement between two runs keyed by (ref_id, sentence)."""
    bk = {(r.ref_id, r.sentence): r for r in b.records}
    n = agree_pure = agree_final = 0
    diffs = []
    for r in a.records:
        other = bk.get((r.ref_id, r.sentence))
        if other is None:
            continue
        n += 1
        agree_pure += int(r.pure_index == other.pure_index)
        agree_final += int(r.final_index == other.final_index)
        if r.final_index != other.final_index:
            diffs.append((r.ref_id, r.sentence, r.final_index, other.final_index))
    return {
        "n": n,
        "pure_agreement": agree_pure / n if n else 0.0,
        "final_agreement": agree_final / n if n else 0.0,
        "diffs": diffs[:100],
    }
