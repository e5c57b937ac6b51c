"""fluid.layers — the layer functions, in one namespace as the
reference's layers/__init__.py gathers them, with the names it re-exports
(``Constant``, ``Normal``, ``Xavier``, ``ParamAttr``, ``Variable``,
``LayerHelper``, ``unique_name``, ``monkey_patch_variable``)."""

from . import (nn, io, sequence, tensor, ops, control_flow,  # noqa: F401
               learning_rate_scheduler, metric, detection)
from .nn import (fc, embedding, softmax, cross_entropy,  # noqa: F401
                 elementwise_add, elementwise_sub, elementwise_mul,
                 elementwise_div, elementwise_max, elementwise_min,
                 elementwise_pow, conv2d, pool2d, batch_norm,
                 softmax_with_cross_entropy, mean, topk, warpctc,
                 ctc_greedy_decoder, edit_distance, layer_norm,
                 causal_self_attention, dropout, square_error_cost,
                 sigmoid_cross_entropy_with_logits, accuracy, mul, matmul,
                 cos_sim, linear_chain_crf, crf_decoding, l2_normalize,
                 multiplex, one_hot, smooth_l1, lrn, maxout, im2sequence,
                 rank_loss, nce, pad, crop, conv2d_transpose, conv3d,
                 conv3d_transpose, pool3d, max_pool2d_with_index,
                 max_pool3d_with_index, unpool, spp, norm, prelu, cumsum,
                 expand, label_smooth, margin_rank_loss,
                 bilinear_tensor_product, is_empty)
from .detection import (prior_box, iou_similarity, box_coder,  # noqa: F401
                        bipartite_match, target_assign, mine_hard_examples,
                        multiclass_nms, detection_output, roi_pool,
                        ssd_loss, multi_box_head, detection_map)
from ..framework import Variable, unique_name  # noqa: F401
from ..initializer import Constant, Normal, Xavier  # noqa: F401
from ..layer_helper import LayerHelper  # noqa: F401
from ..param_attr import ParamAttr  # noqa: F401
from .io import (data, get_places, open_recordio_file,  # noqa: F401
                 open_files, create_shuffle_reader,
                 create_double_buffer_reader, create_multi_pass_reader,
                 read_file)
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .control_flow import (  # noqa: F401
    increment, less_than, equal, create_array, array_write, array_read,
    array_length, While, Switch, StaticRNN, DynamicRNN, beam_search,
    batch_gather, beam_search_decode, IfElse, Print)
from .metric import auc, precision_recall, chunk_eval  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, autoincreased_step_counter)

sum = tensor.sums  # the reference's layers.sum spelling


def monkey_patch_variable():
    """The reference's layers/math_op_patch.py installs +, -, *, / on
    Variable; here Variable has them built in, so this does nothing (as
    in the reference)."""
    return None
