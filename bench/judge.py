"""The comparison that decides `correct`: each sampled response of the
window against the reference's answer to the same request.

Numbers compared, each against the configuration's limit:

    wrong_answers   requests whose answer differs from the reference: a
                    missing response, another doc-only flag, another set
                    of (doc, pos) anchors or of doc-only documents, and,
                    ranked, a top-k list that is not the reference's top k
                    (a document outside it, one missing, or out of order
                    by more than the score limit)
    score_rel_gap   ranked only: the widest gap between a returned score
                    (of an anchor or a document) and the reference's, over
                    the reference's
"""
from __future__ import annotations

import numpy as np

from reference.search import POS_BIAS, POS_SHIFT, anchor_keys, top_docs


def _keys(resp) -> np.ndarray:
    return ((np.asarray(resp.doc, np.int64) << POS_SHIFT)
            | (np.asarray(resp.pos, np.int64) + POS_BIAS))


def _ranked_ok(resp, want, top_k, tol: float) -> tuple[bool, float]:
    """(top-k list sound, widest relative score gap) of a ranked response."""
    gap = 0.0
    docs = [int(d) for d in (resp.doc_ids if resp.doc_ids is not None else [])]
    scores = [float(s) for s in (resp.doc_scores
                                 if resp.doc_scores is not None else [])]
    if want.doc_only:
        # doc-only hits all score alike: the first top_k documents
        return (docs == top_docs(want.doc_scores, top_k)
                and all(s == want.doc_scores[d] for d, s in zip(docs, scores))), gap
    for k, s in zip(_keys(resp).tolist(),
                    np.asarray(resp.anchor_scores).tolist()):
        ref = want.scores[k]
        gap = max(gap, abs(s - ref) / abs(ref))
    n = len(want.doc_scores) if top_k is None else min(top_k, len(want.doc_scores))
    if len(docs) != n or len(set(docs)) != n:
        return False, gap
    if not all(d in want.doc_scores for d in docs):
        return False, gap
    ref = [want.doc_scores[d] for d in docs]
    for s, r in zip(scores, ref):
        if r != 0.0:
            gap = max(gap, abs(s - r) / abs(r))
        elif s != 0.0:
            return False, gap
    slack = lambda x: abs(x) * tol
    for a, b in zip(ref, ref[1:]):
        if b > a + slack(a):
            return False, gap
    floor = min(ref) if ref else 0.0
    chosen = set(docs)
    for d, r in want.doc_scores.items():
        if d not in chosen and r > floor + slack(floor):
            return False, gap
    return True, gap


def judge(specs, responses, answers, ranked: bool, top_k, score_limit):
    """Numbers compared over the sampled requests: `specs` the request
    specs, `responses` the program's (None where none came), `answers` the
    reference's.  Returns ({name: value}, [indices of wrong answers])."""
    wrong = []
    gap = 0.0
    for i, (resp, want) in enumerate(zip(responses, answers)):
        if resp is None or bool(resp.doc_only) != want.doc_only:
            wrong.append(i)
            continue
        if want.doc_only:
            same = np.array_equal(np.unique(np.asarray(resp.doc, np.int64)),
                                  want.docs)
        else:
            same = np.array_equal(anchor_keys(resp.doc, resp.pos), want.keys)
            same &= len(resp.doc) == len(want.keys)
        if same and ranked:
            same, g = _ranked_ok(resp, want, top_k, score_limit)
            gap = max(gap, g)
        if not same:
            wrong.append(i)
    out = {"wrong_answers": len(wrong)}
    if ranked:
        out["score_rel_gap"] = gap
    return out, wrong


class AsResponse:
    """A reference answer in a response's shape: the control puts the
    reference in the program's place."""

    def __init__(self, ans, top_k):
        self.doc_only = ans.doc_only
        if ans.doc_only:
            self.doc, self.pos = ans.docs, np.full(len(ans.docs), -1)
        else:
            self.doc = ans.keys >> POS_SHIFT
            self.pos = (ans.keys & ((1 << POS_SHIFT) - 1)) - POS_BIAS
        if ans.doc_scores is not None:
            self.anchor_scores = np.asarray(
                [ans.scores[k] for k in ans.keys.tolist()])
            self.doc_ids = np.asarray(top_docs(ans.doc_scores, top_k))
            self.doc_scores = np.asarray(
                [ans.doc_scores[d] for d in self.doc_ids.tolist()])
