"""CoNLL-2005 semantic-role-labeling dataset (reference
python/paddle/v2/dataset/conll05.py).

``get_dict()`` -> (word_dict, verb_dict, label_dict); ``test()`` yields the
9-slot SRL sample: (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2 — the
predicate-context word repeated over the sentence —, pred_ids, mark,
label_ids) consumed by the label_semantic_roles book model. Parses the
canonical test.wsj words/props files when cached; otherwise a deterministic
synthetic corpus with grammar-like BIO role structure around each verb."""

from __future__ import annotations

import gzip
import os
import tarfile

import numpy as np

from . import common

WORDDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/wordDict.txt")
VERBDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/verbDict.txt")
TRGDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/targetDict.txt")
EMB_URL = "http://paddlemodels.bj.bcebos.com/conll05st/emb"
DATA_URL = ("http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz")

UNK_IDX = 0

SYNTH_VOCAB = 150
SYNTH_VERBS = 12
# id layout follows the IOB int scheme (type*2 for B, type*2+1 for I,
# last id Outside) so chunk evaluators consume label ids directly
SYNTH_LABELS = ["B-A0", "I-A0", "B-A1", "I-A1", "B-V", "I-V", "O"]
SYNTH_SENTENCES = 300


def load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _synth_dicts():
    word_dict = {f"w{i}": i for i in range(SYNTH_VOCAB)}
    word_dict["<unk>"] = len(word_dict)
    verb_dict = {f"v{i}": i for i in range(SYNTH_VERBS)}
    label_dict = {}
    for lbl in SYNTH_LABELS:
        label_dict.setdefault(lbl, len(label_dict))
    return word_dict, verb_dict, label_dict


def _have_real():
    return (common.have_file(WORDDICT_URL, "conll05st")
            and common.have_file(VERBDICT_URL, "conll05st")
            and common.have_file(TRGDICT_URL, "conll05st")
            and common.have_file(DATA_URL, "conll05st"))


def get_dict():
    """(word_dict, verb_dict, label_dict) — reference conll05.get_dict."""
    if _have_real():
        base = os.path.join(common.DATA_HOME, "conll05st")
        return (load_dict(os.path.join(base, "wordDict.txt")),
                load_dict(os.path.join(base, "verbDict.txt")),
                load_dict(os.path.join(base, "targetDict.txt")))
    return _synth_dicts()


def get_embedding():
    """The pretrained embedding matrix when cached, else a deterministic
    normal init of the synthetic vocab (reference conll05.get_embedding
    loads a binary float file)."""
    word_dict, _, _ = get_dict()
    if common.have_file(EMB_URL, "conll05st"):
        path = os.path.join(common.DATA_HOME, "conll05st", "emb")
        data = np.fromfile(path, dtype=np.float32)
        return data.reshape(len(word_dict), -1)
    rng = np.random.RandomState(17)
    return rng.normal(0, 0.1, (len(word_dict), 32)).astype(np.float32)


def _synth_corpus(seed):
    """(sentence words, verb index, BIO labels): A0 span, verb, A1 span."""
    rng = np.random.RandomState(seed)
    for _ in range(SYNTH_SENTENCES):
        n0 = int(rng.randint(1, 4))
        n1 = int(rng.randint(1, 5))
        verb = f"v{int(rng.randint(0, SYNTH_VERBS))}"
        words = ([f"w{int(rng.randint(0, SYNTH_VOCAB))}" for _ in range(n0)]
                 + [verb]
                 + [f"w{int(rng.randint(0, SYNTH_VOCAB))}"
                    for _ in range(n1)])
        labels = (["B-A0"] + ["I-A0"] * (n0 - 1) + ["B-V"]
                  + ["B-A1"] + ["I-A1"] * (n1 - 1))
        yield words, n0, labels


def _real_corpus():
    """Walk test.wsj words/props files inside the conll05st tests tarball
    (reference corpus_reader over words.gz/props.gz columns)."""
    path = os.path.join(common.DATA_HOME, "conll05st", DATA_URL.split("/")[-1])
    with tarfile.open(path) as tf:
        words_member = props_member = None
        for m in tf.getmembers():
            if m.name.endswith("test.wsj.words.gz"):
                words_member = m
            elif m.name.endswith("test.wsj.props.gz"):
                props_member = m
        with gzip.GzipFile(fileobj=tf.extractfile(words_member)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(props_member)) as pf:
            sentences = []
            labels = []
            one_seg = []
            for word, label in zip(wf, pf):
                word = word.decode().strip()
                label = label.decode().strip().split()
                if len(label) == 0:  # end of sentence
                    for i in range(len(one_seg[0]) - 1):
                        a_kind = [x[i + 1] for x in one_seg]
                        labels.append(a_kind)
                    if len(labels) >= 1:
                        verb_list = []
                        for x in one_seg:
                            if x[0] != "-":
                                verb_list.append(x[0])
                        for i, lbl in enumerate(labels):
                            lemma = verb_list[i] \
                                if i < len(verb_list) else None
                            cur_tag = "O"
                            is_in_bracket = False
                            lbl_seq = []
                            verb_word = ""
                            for l in lbl:
                                if l == "*" and not is_in_bracket:
                                    lbl_seq.append("O")
                                elif l == "*" and is_in_bracket:
                                    lbl_seq.append("I-" + cur_tag)
                                elif l == "*)":
                                    lbl_seq.append("I-" + cur_tag)
                                    is_in_bracket = False
                                elif l.startswith("(") and l.endswith(")"):
                                    cur_tag = l[1:l.find("*")]
                                    lbl_seq.append("B-" + cur_tag)
                                elif l.startswith("("):
                                    cur_tag = l[1:l.find("*")]
                                    lbl_seq.append("B-" + cur_tag)
                                    is_in_bracket = True
                                else:
                                    raise RuntimeError(f"unexpected label: {l}")
                            verb_idx = lbl_seq.index("B-V") \
                                if "B-V" in lbl_seq else 0
                            yield sentences, verb_idx, lbl_seq, lemma
                    sentences = []
                    labels = []
                    one_seg = []
                else:
                    sentences.append(word)
                    one_seg.append(label)


def reader_creator(corpus, word_dict, predicate_dict, label_dict):
    def reader():
        for item in corpus():
            # corpus yields (sentence, verb_index, labels[, lemma]): the
            # real props files carry the predicate LEMMA (verbDict is
            # lemma-keyed, reference conll05.py:130 verb_list[i]); the
            # synthetic corpus's surface form IS its lemma
            sentence, verb_index, labels = item[:3]
            lemma = item[3] if len(item) > 3 and item[3] is not None \
                else (sentence[verb_index]
                      if verb_index < len(sentence) else None)
            sen_len = len(sentence)
            if verb_index >= sen_len or lemma is None:
                continue
            predicate = lemma
            if predicate not in predicate_dict:
                continue
            # mark covers the 5-token context window around the verb
            # (reference reader_creator:156-181 sets mark at verb_index-2
            # .. verb_index+2)
            mark = [0] * sen_len
            for off in range(-2, 3):
                if 0 <= verb_index + off < sen_len:
                    mark[verb_index + off] = 1

            def ctx(off, default):
                i = verb_index + off
                return sentence[i] if 0 <= i < sen_len else default

            ctx_words = [ctx(-2, "bos"), ctx(-1, "bos"), ctx(0, "bos"),
                         ctx(1, "eos"), ctx(2, "eos")]
            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctx_idx = [[word_dict.get(w, UNK_IDX)] * sen_len
                       for w in ctx_words]
            pred_idx = [predicate_dict[predicate]] * sen_len
            label_idx = [label_dict[l] for l in labels
                         if l in label_dict]
            if len(label_idx) != sen_len:
                continue
            yield (word_idx, ctx_idx[0], ctx_idx[1], ctx_idx[2], ctx_idx[3],
                   ctx_idx[4], pred_idx, mark, label_idx)

    return reader


def test():
    word_dict, verb_dict, label_dict = get_dict()
    if _have_real():
        corpus = _real_corpus
    else:
        corpus = lambda: _synth_corpus(23)
    return reader_creator(corpus, word_dict, verb_dict, label_dict)


def train():
    """The reference ships only the test split (train is licensed); the
    synthetic fallback provides a train split so book models can fit."""
    word_dict, verb_dict, label_dict = get_dict()
    corpus = lambda: _synth_corpus(31)
    if _have_real():
        corpus = _real_corpus
    return reader_creator(corpus, word_dict, verb_dict, label_dict)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    conll05.py:252 — which converts the test split for both names; the
    train corpus is license-gated there and here)."""
    common.convert(path, test(), 1000, "conl105_train")
    common.convert(path, test(), 1000, "conl105_test")
