"""fluid.layers — the layer functions ported so far, in one namespace as
the reference's layers/__init__.py gathers them."""

from . import (nn, io, sequence, tensor, ops, control_flow,  # noqa: F401
               learning_rate_scheduler, metric)
from .nn import (fc, embedding, softmax, cross_entropy,  # noqa: F401
                 elementwise_add, elementwise_sub, elementwise_mul,
                 elementwise_div, elementwise_max, elementwise_min,
                 elementwise_pow, conv2d, pool2d, batch_norm,
                 softmax_with_cross_entropy, mean, topk, warpctc,
                 ctc_greedy_decoder, edit_distance, layer_norm,
                 causal_self_attention, dropout, square_error_cost,
                 sigmoid_cross_entropy_with_logits, accuracy, mul, matmul,
                 cos_sim, linear_chain_crf, crf_decoding, l2_normalize,
                 multiplex, one_hot, smooth_l1)
from .io import data, get_places  # noqa: F401
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
