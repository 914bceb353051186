"""Work of kernel 5 with bfloat16 operands (csrc/critic_train_bf16.cu): one
Adam iteration of one agent's critic d1 -> h -> h -> 1 on T rows.

Operations: frozen from chip_smoke.py:507-513 (``_critic_iter_ops``): the
forward and backward products at 2 operations a multiply-add (the tensor
cores' work), and ~9h + 2 elementwise operations a row with ~13 a
parameter for Adam (the float32 pipe's).  Bytes, for A agents, float32
(chip_smoke.py:1661-1681): the parameters and both moments read and
written, the observations and returns read, the counts."""


def iter_ops(d1: int, h: int, t_len: int):
    """(product operations, other operations) of one iteration."""
    macs = 2 * d1 * h + 2 * (h + 1) * h + h * h + 2 * (h + 1) + h
    params = d1 * h + (h + 1) * h + (h + 1)
    return t_len * 2 * macs, t_len * (9 * h + 2) + 13 * params


def n_params(d1: int, h: int) -> int:
    return d1 * h + (h + 1) * h + (h + 1)


def nbytes(d1: int, h: int, agents: int, t_len: int) -> int:
    """Bytes for one launch over ``agents`` (any number of iterations)."""
    d = d1 - 1
    return (4 * (6 * agents * n_params(d1, h) + agents * t_len * d
                 + agents * t_len) + 8 * agents)
