"""MovieLens-1M dataset (reference python/paddle/v2/dataset/movielens.py).

Samples are ``user.value() + movie.value() + [[rating]]``:
[user_idx, gender(0/1), age_idx, job_id, movie_idx, category_ids,
title_word_ids, [rating in [-5, 5]]] — the recommender_system book schema.
Parses ml-1m.zip when cached; otherwise builds a deterministic synthetic
catalog whose ratings follow a low-rank user x movie preference structure
(so factorization models converge)."""

from __future__ import annotations

import os
import random
import re
import zipfile

import numpy as np

from . import common

URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"

AGES = [1, 18, 25, 35, 45, 50, 56]

SYNTH_USERS, SYNTH_MOVIES, SYNTH_RATINGS = 120, 80, 4000
SYNTH_CATEGORIES = ["Action", "Comedy", "Drama", "Horror", "Romance",
                    "SciFi", "Thriller", "Animation"]
SYNTH_TITLE_VOCAB = 60
SYNTH_JOBS = 21


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [CATEGORIES_DICT[c] for c in self.categories],
                [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = AGES.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), gender({'M' if self.is_male else 'F'}), "
                f"age({AGES[self.age]}), job({self.job_id})>")


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
USER_INFO = None
_RATINGS = None


def _synth_init():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO, _RATINGS
    rng = np.random.RandomState(42)
    CATEGORIES_DICT = {c: i for i, c in enumerate(SYNTH_CATEGORIES)}
    MOVIE_TITLE_DICT = {f"t{i}": i for i in range(SYNTH_TITLE_VOCAB)}
    MOVIE_INFO = {}
    for m in range(1, SYNTH_MOVIES + 1):
        cats = [SYNTH_CATEGORIES[i] for i in
                rng.choice(len(SYNTH_CATEGORIES),
                           size=rng.randint(1, 3), replace=False)]
        title = " ".join(f"t{int(t)}" for t in
                         rng.randint(0, SYNTH_TITLE_VOCAB,
                                     rng.randint(1, 4)))
        MOVIE_INFO[m] = MovieInfo(m, cats, title)
    USER_INFO = {}
    for u in range(1, SYNTH_USERS + 1):
        USER_INFO[u] = UserInfo(u, "M" if rng.rand() < 0.5 else "F",
                                AGES[int(rng.randint(0, len(AGES)))],
                                int(rng.randint(0, SYNTH_JOBS)))
    # low-rank preference: rating ~ <u_vec, m_vec>
    uvec = rng.normal(0, 1, (SYNTH_USERS + 1, 4))
    mvec = rng.normal(0, 1, (SYNTH_MOVIES + 1, 4))
    _RATINGS = []
    for _ in range(SYNTH_RATINGS):
        u = int(rng.randint(1, SYNTH_USERS + 1))
        m = int(rng.randint(1, SYNTH_MOVIES + 1))
        score = float(np.clip(np.round(2.5 + 1.2 * uvec[u] @ mvec[m]), 1, 5))
        _RATINGS.append((u, m, score))


def __initialize_meta_info__():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO, _RATINGS
    if MOVIE_INFO is not None:
        return
    if not common.have_file(URL, "movielens"):
        _synth_init()
        return
    fn = os.path.join(common.DATA_HOME, "movielens", URL.split("/")[-1])
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    MOVIE_INFO = {}
    MOVIE_TITLE_DICT = {}
    CATEGORIES_DICT = {}
    USER_INFO = {}
    with zipfile.ZipFile(fn) as package:
        for info in package.infolist():
            assert isinstance(info, zipfile.ZipInfo)
        with package.open("ml-1m/movies.dat") as mov:
            for line in mov:
                line = line.decode(encoding="latin1").strip()
                movie_id, title, categories = line.split("::")
                categories = categories.split("|")
                for c in categories:
                    CATEGORIES_DICT.setdefault(c, len(CATEGORIES_DICT))
                title = pattern.match(title).group(1)
                MOVIE_INFO[int(movie_id)] = MovieInfo(movie_id, categories,
                                                      title)
                for w in title.split():
                    MOVIE_TITLE_DICT.setdefault(w.lower(),
                                                len(MOVIE_TITLE_DICT))
        with package.open("ml-1m/users.dat") as user:
            for line in user:
                uid, gender, age, job, _ = \
                    line.decode(encoding="latin1").strip().split("::")
                USER_INFO[int(uid)] = UserInfo(uid, gender, age, job)
        _RATINGS = []
        with package.open("ml-1m/ratings.dat") as rating:
            for line in rating:
                uid, mov_id, r, _ = \
                    line.decode(encoding="latin1").strip().split("::")
                _RATINGS.append((int(uid), int(mov_id), float(r)))


def __reader__(rand_seed=0, test_ratio=0.1, is_test=False):
    __initialize_meta_info__()
    rand = random.Random(x=rand_seed)
    for uid, mov_id, r in _RATINGS:
        if (rand.random() < test_ratio) == is_test:
            usr = USER_INFO[uid]
            mov = MOVIE_INFO[mov_id]
            # rating rescaled to [-5, 5] like the reference (:156)
            yield usr.value() + mov.value() + [[r * 2 - 5.0]]


def train():
    return lambda: __reader__(is_test=False)


def test():
    return lambda: __reader__(is_test=True)


def get_movie_title_dict():
    __initialize_meta_info__()
    return MOVIE_TITLE_DICT


def max_movie_id():
    __initialize_meta_info__()
    return max(MOVIE_INFO.keys())


def max_user_id():
    __initialize_meta_info__()
    return max(USER_INFO.keys())


def max_job_id():
    __initialize_meta_info__()
    return max(u.job_id for u in USER_INFO.values())


def movie_categories():
    __initialize_meta_info__()
    return CATEGORIES_DICT


def user_info():
    __initialize_meta_info__()
    return USER_INFO


def movie_info():
    __initialize_meta_info__()
    return MOVIE_INFO


def age_table():
    return list(AGES)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    movielens.py:253)."""
    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
