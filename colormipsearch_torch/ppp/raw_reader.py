"""Raw PatchPerPix results reader.

Counterpart of ppp/RawPPPMatchesReader.java:27-160 +
ppp/RawSkeletonMatches.java: streams the original per-EM
cov_scores_*.json files into PPPMatchEntity objects. The raw files nest
{emFullName: {lmFullName: {skel_ids, nblast_scores, coverages, colors,
cov_score, aggregate_coverage, mirrored, rank, all_*...}}} with the list
fields encoded as numpy-ish strings ("[  379  5477 ...]").

Copy of `colormipsearch_tpu/ppp/raw_reader.py`.
"""

from __future__ import annotations

import json
import re
from typing import Iterator, List, Optional

from ..model.entities import PPPMatchEntity


def _normalize_array_string(s: Optional[str]) -> str:
    """Fix numpy-printed arrays: strip newlines, insert commas between
    whitespace-separated entries (RawPPPMatchesReader.normalizeArrayString)."""
    if not s:
        return "[]"
    s = s.replace("\n", " ")
    # insert commas between numbers separated by whitespace
    s = re.sub(r"(?<=[\d.\]])\s+(?=[-\d\[])", ", ", s.strip())
    return s


def _parse_list(s: Optional[str]) -> list:
    if s is None:
        return []
    try:
        return json.loads(_normalize_array_string(s))
    except json.JSONDecodeError:
        return []


def _skeleton_matches(entry: dict, only_best: bool) -> List[dict]:
    ids = [str(i) for i in _parse_list(entry.get("skel_ids"))]
    nblast = _parse_list(entry.get("nblast_scores"))
    cov = _parse_list(entry.get("coverages"))
    colors = _parse_list(entry.get("colors"))
    seen = set()
    out = []

    def add(ids_, nblast_, cov_, colors_):
        for i, sid in enumerate(ids_):
            sid = str(sid)
            if sid in seen:
                continue
            seen.add(sid)
            m = {"id": sid}
            if i < len(nblast_):
                m["nblastScore"] = nblast_[i]
            if i < len(cov_):
                m["coverage"] = cov_[i]
            if i < len(colors_):
                m["color"] = colors_[i]
            out.append(m)

    add(ids, nblast, cov, colors)
    if not only_best:
        add([str(i) for i in _parse_list(entry.get("all_skel_ids"))],
            _parse_list(entry.get("all_nblast_scores")),
            _parse_list(entry.get("all_coverages")),
            _parse_list(entry.get("all_colors")))
    return out


def read_raw_ppp_matches(path: str, only_best_matches: bool = False,
                         include_skeletons: bool = True
                         ) -> Iterator[PPPMatchEntity]:
    with open(path) as f:
        doc = json.load(f)
    for em_name, lm_matches in doc.items():
        for lm_name, entry in lm_matches.items():
            m = PPPMatchEntity()
            m.source_em_name = em_name
            m.source_lm_name = lm_name
            m.cov_score = entry.get("cov_score")
            m.aggregate_coverage = entry.get("aggregate_coverage")
            m.mirrored = bool(entry.get("mirrored", False))
            m.rank = entry.get("rank")
            if include_skeletons:
                m.skeleton_matches = _skeleton_matches(entry, only_best_matches)
            yield m
