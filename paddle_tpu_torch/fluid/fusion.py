"""Program-level op fusion (counterpart of paddle_tpu/fluid/fusion.py:28).

``fuse_conv_bn`` rewrites every eligible ``conv2d -> batch_norm (-> relu)``
chain in a program's global block into ONE ``fused_conv2d_bn`` op
(ops/fused_ops.py), whose lowering picks the CUDA kernel or the plain op
chain per dispatch. Eligibility is purely structural: the conv feeds the
batch_norm's X directly, the intermediate has no other consumer, and conv
``data_format`` equals bn ``data_layout``. Kernel-size/stride eligibility is
decided at dispatch by the kernel's ``supported()``. Under the
``verify_passes`` flag the rewritten program is re-verified
(fluid/analysis, as reference fusion.py:91-92).
"""

from __future__ import annotations

from .framework import Operator


def fuse_conv_bn(program):
    """Fuse conv2d→batch_norm(→relu) chains in block 0, in place.
    Returns the number of chains fused."""
    block = program.global_block()
    uses: dict = {}
    for op in block.ops:
        for n in op.input_arg_names():
            uses[n] = uses.get(n, 0) + 1

    ops = block.ops
    new_ops = []
    i = 0
    fused = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        out = op.output("Output")
        if (op.type == "conv2d" and nxt is not None
                and nxt.type == "batch_norm" and out
                and nxt.input("X") == out
                and uses.get(out[0], 0) == 1
                and (nxt.attr("data_layout", "NCHW") or "NCHW")
                == (op.attr("data_format", "NCHW") or "NCHW")):
            act = ""
            final_out = nxt.output("Y")
            j = i + 2
            if (j < len(ops) and ops[j].type == "relu"
                    and ops[j].input("X") == final_out
                    and uses.get(final_out[0], 0) == 1
                    and not ops[j].attrs):
                act = "relu"
                final_out = ops[j].output("Out")
                j += 1
            attrs = dict(op.attrs)
            for k in ("epsilon", "momentum", "is_test", "data_layout"):
                if k in nxt.attrs:
                    attrs[k] = nxt.attrs[k]
            attrs["act"] = act
            new_ops.append(Operator(
                block, "fused_conv2d_bn",
                inputs={"Input": op.input("Input"),
                        "Filter": op.input("Filter"),
                        "Scale": nxt.input("Scale"),
                        "Bias": nxt.input("Bias"),
                        "Mean": nxt.input("Mean"),
                        "Variance": nxt.input("Variance")},
                outputs={"Output": final_out,
                         "MeanOut": nxt.output("MeanOut"),
                         "VarianceOut": nxt.output("VarianceOut"),
                         "SavedMean": nxt.output("SavedMean"),
                         "SavedVariance": nxt.output("SavedVariance")},
                attrs=attrs))
            fused += 1
            i = j
            continue
        new_ops.append(op)
        i += 1
    if fused:
        block.ops[:] = new_ops
        program._bump_version()
        # verify_passes: some op still reading the removed conv
        # intermediate is a PTL003/PTL004 find here
        from .analysis import verify_pass_output
        verify_pass_output(program, "fuse_conv_bn")
    return fused


__all__ = ["fuse_conv_bn"]
