"""Tooling parity with the reference's ``python/paddle/utils``.

Reference inventory (python/paddle/utils/) and where each capability lives:

  dump_config.py        -> utils/dump_config.py (Program debug/JSON dump)
  dump_v2_config.py     -> v2 Topology.serialize_for_inference + show_pb
  make_model_diagram.py -> utils/make_model_diagram.py (Program graphviz)
  merge_model.py        -> utils/merge_model.py (topology+params tar)
  plotcurve.py          -> utils/plotcurve.py (log -> cost curve)
  show_pb.py            -> utils/show_pb.py (JSON model pretty-print)
  image_util.py /
  preprocess_img.py     -> v2/image.py (load/resize/crop/flip/
                           simple_transform; the later-generation module
                           the reference itself migrated to)
  image_multiproc.py    -> reader decorators xmap_readers (parallel image
                           preprocessing lives in the reader layer here)
  predefined_net.py     -> v2/networks.py + fluid/nets.py
  torch2paddle.py       -> out of scope: imports Torch7 binary blobs; the
                           checkpoint-compat loaders (checkpoint_compat.py)
                           are this framework's foreign-weights door

checkpoint_compat.py is native to this framework (reference-format LSTM
weight conversion used by the checkpoint tests).
"""

from . import dump_config, make_model_diagram, merge_model, plotcurve, \
    show_pb
from .checkpoint_compat import (convert_reference_lstm_weight,
                                convert_reference_lstm_bias)
from .merge_model import merge_v2_model, load_merged_model

__all__ = ["convert_reference_lstm_weight", "convert_reference_lstm_bias",
           "dump_config", "make_model_diagram", "merge_model", "plotcurve",
           "show_pb", "merge_v2_model", "load_merged_model"]
