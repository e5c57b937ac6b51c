"""Block-graph walkers: read-before-write and written-name analysis
(counterpart of paddle_tpu/core/block_walk.py). The executor uses them to
find a block's state surface."""

from __future__ import annotations

SUB_BLOCK_ATTRS = ("sub_block", "sub_block_false")


def free_reads(program, block_idx, initial_defined=()):
    """Names the block (and nested sub-blocks) reads before writing, in
    first-read order."""
    free, seen = [], set(initial_defined)

    def walk(bidx, defined):
        block = program.blocks[bidx]
        defined = set(defined)
        for op in block.ops:
            for n in op.input_arg_names():
                if n not in defined and n not in seen:
                    seen.add(n)
                    free.append(n)
            for attr in SUB_BLOCK_ATTRS:
                if op.has_attr(attr):
                    walk(op.attr(attr), defined)
            for n in op.output_arg_names():
                defined.add(n)

    walk(block_idx, set(initial_defined))
    return free


def written_names(program, block_idx):
    """Names the block (and nested sub-blocks) writes, in first-write
    order."""
    seen, out = set(), []

    def walk(bidx):
        block = program.blocks[bidx]
        for op in block.ops:
            for n in op.output_arg_names():
                if n not in seen:
                    seen.add(n)
                    out.append(n)
            for attr in SUB_BLOCK_ATTRS:
                if op.has_attr(attr):
                    walk(op.attr(attr))

    walk(block_idx)
    return out
