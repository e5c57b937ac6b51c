"""v2 input-type declarations (reference python/paddle/v2/data_type.py over
trainer/PyDataProvider2.py InputType): each describes how a data layer's
feed is shaped, and here directly determines the fluid var the layer
materializes (dtype + lod level)."""


class InputType:
    def __init__(self, dim, seq_type, dtype, shape, lod_level):
        self.dim = dim
        self.seq_type = seq_type
        self.dtype = dtype
        self.shape = shape
        self.lod_level = lod_level


def dense_vector(dim):
    return InputType(dim, 0, "float32", [dim], 0)


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32", [dim], 1)


def integer_value(value_range):
    return InputType(value_range, 0, "int64", [1], 0)


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64", [1], 1)


def sparse_binary_vector(dim):
    # fed as index lists; lowered as an id sequence the consumer one-hots
    return InputType(dim, 0, "int64", [1], 1)


__all__ = ["InputType", "dense_vector", "dense_vector_sequence",
           "integer_value", "integer_value_sequence",
           "sparse_binary_vector"]
