"""MQ2007 learning-to-rank dataset (reference
python/paddle/v2/dataset/mq2007.py — LETOR 4.0 query-document features).

``train(format=...)/test(format=...)`` with the reference's four sample
formats over 46-dim feature vectors:
  pointwise: (relevance_score, feature_vector)
  pairwise : (label=1, better_vector, worse_vector)
  listwise : (score_list, feature_vector_list) per query
  plain_txt: (query_id, relevance_score, feature_vector)
Parses the canonical MQ2007 Fold text files ("rel qid:N 1:v ... 46:v") when
cached; otherwise a deterministic synthetic LETOR corpus whose relevance is
a noisy linear function of the features (rankers learn it)."""

from __future__ import annotations

import os

import numpy as np

from . import common

URL = ("http://research.microsoft.com/en-us/um/beijing/projects/letor/"
       "LETOR4.0/Data/MQ2007.rar")

N_FEATURES = 46
SYNTH_QUERIES_TRAIN, SYNTH_QUERIES_TEST = 60, 15
SYNTH_DOCS_PER_QUERY = 8


class Query:
    def __init__(self, query_id, relevance_score, feature_vector):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector


class QueryList:
    def __init__(self, query_id):
        self.query_id = query_id
        self.querylist = []

    def append(self, q):
        self.querylist.append(q)

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)


def _parse_line(line):
    """'2 qid:10032 1:0.05 ... 46:0.07 #docid = ...' -> Query."""
    head, _, _ = line.partition("#")
    parts = head.split()
    rel = int(parts[0])
    qid = int(parts[1].split(":")[1])
    feats = np.full(N_FEATURES, -1.0, np.float32)
    for kv in parts[2:]:
        k, _, v = kv.partition(":")
        idx = int(k) - 1
        if 0 <= idx < N_FEATURES:
            feats[idx] = float(v)
    return Query(qid, rel, feats)


def load_from_text(filepath, fill_missing=-1):
    lists = {}
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            q = _parse_line(line)
            lists.setdefault(q.query_id, QueryList(q.query_id)).append(q)
    return list(lists.values())


def _synth_querylists(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(55).normal(0, 1, N_FEATURES)
    out = []
    for qi in range(n_queries):
        ql = QueryList(qi)
        for _ in range(SYNTH_DOCS_PER_QUERY):
            f = rng.rand(N_FEATURES).astype(np.float32)
            score = f @ w + 0.3 * rng.normal()
            rel = int(np.clip(np.floor((score - w.mean()) / 2.0 + 1), 0, 2))
            ql.append(Query(qi, rel, f))
        out.append(ql)
    return out


def gen_plain_txt(querylist):
    for q in querylist:
        yield querylist.query_id, q.relevance_score, np.array(
            q.feature_vector)


def gen_point(querylist):
    for q in querylist:
        yield q.relevance_score, np.array(q.feature_vector)


def gen_pair(querylist, partial_order="full"):
    docs = sorted(querylist, key=lambda q: -q.relevance_score)
    for i in range(len(docs)):
        for j in range(i + 1, len(docs)):
            if docs[i].relevance_score > docs[j].relevance_score:
                yield (np.array([1.0]), np.array(docs[i].feature_vector),
                       np.array(docs[j].feature_vector))


def gen_list(querylist):
    yield (np.array([q.relevance_score for q in querylist]),
           np.array([q.feature_vector for q in querylist]))


def _reader(split, fmt):
    fold = os.path.join(common.DATA_HOME, "mq2007", "Fold1",
                        f"{split}.txt")

    def reader():
        if os.path.exists(fold):
            querylists = load_from_text(fold)
        else:
            seed = 3 if split == "train" else 11
            n = SYNTH_QUERIES_TRAIN if split == "train" \
                else SYNTH_QUERIES_TEST
            querylists = _synth_querylists(n, seed)
        for ql in querylists:
            if fmt == "plain_txt":
                yield from gen_plain_txt(ql)
            elif fmt == "pointwise":
                yield from gen_point(ql)
            elif fmt == "pairwise":
                yield from gen_pair(ql)
            elif fmt == "listwise":
                yield from gen_list(ql)
            else:
                raise ValueError(f"unknown mq2007 format {fmt!r}")

    return reader


def train(format="pairwise"):
    return _reader("train", format)


def test(format="pairwise"):
    return _reader("test", format)
