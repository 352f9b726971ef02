"""Per-segment inverted text index ("Text IVF" — paper §4: "implemented in
a similar manner by replacing centroids with the corpus terms").

Level 1: term dictionary (term -> posting range); level 2: posting blocks
of (row, tf) pairs. contains() gives a bitmap; the BM25-ish iterator gives
sorted access for NRA text-relevance ranking (distance = 1 / (1 + score)
so smaller = more relevant, matching the ascending-distance contract).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.index.base import ExactSortedAccess, SecondaryIndex
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.core.segment import pack_object_array, unpack_object_array

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(str(text).lower())


class InvertedTextIndex(SecondaryIndex):
    kind = "inverted"

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.postings: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.doc_len: Optional[np.ndarray] = None
        self.avg_len = 1.0
        self.n_docs = 0

    def build(self, segment, column) -> None:
        texts = segment.columns[column.name]
        self.n_docs = len(texts)
        lens = np.zeros(self.n_docs, np.float32)
        acc: Dict[str, Dict[int, int]] = {}
        for i, t in enumerate(texts):
            toks = tokenize(t)
            lens[i] = len(toks)
            for tok in toks:
                acc.setdefault(tok, {})
                acc[tok][i] = acc[tok].get(i, 0) + 1
        self.doc_len = lens
        self.avg_len = float(lens.mean()) if self.n_docs else 1.0
        for term, hits in acc.items():
            rows = np.fromiter(hits.keys(), np.int64, len(hits))
            tfs = np.fromiter(hits.values(), np.float32, len(hits))
            order = np.argsort(rows)
            self.postings[term] = (rows[order], tfs[order])

    def merge(self, parts, merged_seg, column, row_maps) -> None:
        """Posting-list merge: remap each part's postings through the
        compaction row maps (shadowed docs fall out as -1), concatenate
        per term, and re-sort by row id.  No re-tokenization — the cost
        is O(vocabulary + postings), not O(corpus tokens)."""
        self.n_docs = merged_seg.n_rows
        doc_len = np.zeros(self.n_docs, np.float32)
        acc: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        for part, rmap in zip(parts, row_maps):
            if part.doc_len is not None and len(part.doc_len):
                survived = rmap >= 0
                # every merged row comes from exactly one part (the
                # winning version), so this scatter never collides
                doc_len[rmap[survived]] = part.doc_len[survived]
            for term, (rows, tfs) in part.postings.items():
                new_rows = rmap[rows]
                keep = new_rows >= 0
                if keep.any():
                    acc.setdefault(term, []).append(
                        (new_rows[keep], tfs[keep]))
        self.doc_len = doc_len
        self.avg_len = float(doc_len.mean()) if self.n_docs else 1.0
        self.postings = {}
        for term, chunks in acc.items():
            if len(chunks) == 1:
                rows, tfs = chunks[0]
            else:
                rows = np.concatenate([c[0] for c in chunks])
                tfs = np.concatenate([c[1] for c in chunks])
            order = np.argsort(rows)
            self.postings[term] = (rows[order], tfs[order])

    # -------------------------------------------------------- persistence
    def to_arrays(self):
        """Dictionary + postings flattened to flat arrays: sorted terms
        as an offsets+utf8 blob, per-term posting ranges, concatenated
        (row, tf) pairs."""
        terms = sorted(self.postings)
        term_offsets, term_blob = pack_object_array(
            np.asarray(terms, object))
        rows = [self.postings[t][0] for t in terms]
        tfs = [self.postings[t][1] for t in terms]
        post_offsets = np.zeros(len(terms) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=post_offsets[1:])
        return {
            "term_blob": term_blob,
            "term_offsets": term_offsets,
            "post_offsets": post_offsets,
            "post_rows": np.concatenate(rows).astype(np.int64)
            if rows else np.zeros(0, np.int64),
            "post_tfs": np.concatenate(tfs).astype(np.float32)
            if tfs else np.zeros(0, np.float32),
            "doc_len": np.asarray(
                self.doc_len if self.doc_len is not None else [],
                np.float32),
            "meta": np.asarray([self.avg_len, float(self.n_docs)],
                               np.float64),
        }

    def from_arrays(self, arrays, segment, column) -> None:
        terms = unpack_object_array(
            np.asarray(arrays["term_offsets"], np.int64),
            np.asarray(arrays["term_blob"], np.uint8), as_str=True)
        off = np.asarray(arrays["post_offsets"], np.int64)
        rows = np.asarray(arrays["post_rows"], np.int64)
        tfs = np.asarray(arrays["post_tfs"], np.float32)
        self.postings = {
            str(t): (rows[off[i]:off[i + 1]], tfs[off[i]:off[i + 1]])
            for i, t in enumerate(terms)}
        self.doc_len = np.asarray(arrays["doc_len"], np.float32)
        self.avg_len = float(arrays["meta"][0])
        self.n_docs = int(arrays["meta"][1])

    # ------------------------------------------------------------- access
    def bitmap(self, segment, predicate) -> np.ndarray:
        mask = np.zeros(segment.n_rows, bool)
        entry = self.postings.get(predicate.term.lower())
        if entry is not None:
            mask[entry[0]] = True
        return mask

    def _bm25(self, terms) -> Tuple[np.ndarray, np.ndarray]:
        scores: Dict[int, float] = {}
        for term in terms:
            entry = self.postings.get(term.lower())
            if entry is None:
                continue
            rows, tfs = entry
            df = len(rows)
            idf = math.log(1 + (self.n_docs - df + 0.5) / (df + 0.5))
            dl = self.doc_len[rows]
            tf_norm = tfs * (self.k1 + 1) / (
                tfs + self.k1 * (1 - self.b + self.b * dl / self.avg_len))
            for r, s in zip(rows, idf * tf_norm):
                scores[int(r)] = scores.get(int(r), 0.0) + float(s)
        if not scores:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        rows = np.fromiter(scores.keys(), np.int64, len(scores))
        vals = np.fromiter(scores.values(), np.float32, len(scores))
        return vals, rows

    def iterator(self, segment, query) -> ExactSortedAccess:
        """Sorted access for NRA in EXACTLY the ``TextRank`` metric:
        d = 1 / (1 + 10 * Σ_t tf(t, doc) / (len(doc) + 1)), computed from
        the posting tfs and stored doc lengths with the same float64
        arithmetic ``rank_distances`` uses, then cast to float32 — so the
        distances NRA books as bounds ARE the distances refinement
        scores with.  (A BM25-ordered stream certifies bounds in a
        different metric and silently breaks the NRA winner-set
        guarantee.)  Rows matching no query term sit at the metric's
        ceiling 1.0 and are never yielded; stream exhaustion raises the
        modality bottom to dmax = 1.0, which is their exact distance."""
        terms = query if isinstance(query, (list, tuple)) else [query]
        tf_sum: Dict[int, float] = {}
        for term in terms:                  # duplicates count twice, as in
            entry = self.postings.get(str(term).lower())  # rank_distances
            if entry is None:
                continue
            for r, tf in zip(*entry):
                tf_sum[int(r)] = tf_sum.get(int(r), 0.0) + float(tf)
        if not tf_sum:
            return ExactSortedAccess(np.zeros((0,), np.float32),
                                     np.zeros((0,), np.int64))
        rows = np.fromiter(tf_sum.keys(), np.int64, len(tf_sum))
        tfs = np.fromiter(tf_sum.values(), np.float64, len(tf_sum))
        score = tfs / (self.doc_len[rows].astype(np.float64) + 1.0)
        dist = (1.0 / (1.0 + score * 10.0)).astype(np.float32)
        return ExactSortedAccess(dist, rows)

    # ---------------------------------------------------------- optimizer
    def selectivity(self, segment, predicate) -> float:
        if segment.n_rows == 0:
            return 0.0
        entry = self.postings.get(predicate.term.lower())
        return (len(entry[0]) / segment.n_rows) if entry is not None else 0.0

    def probe_cost_blocks(self, segment, predicate) -> float:
        entry = self.postings.get(predicate.term.lower())
        n = len(entry[0]) if entry is not None else 0
        return 1.0 + n / BLOCK_ROWS           # dictionary + posting blocks
