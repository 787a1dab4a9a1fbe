"""The work a kernel has to do, counted from the inputs' shapes and the
states' data alone: never from the program's own structures (its chunk
table, records, block layout or tile flags), so a kernel redesigned later
is read against the same work.

Rows are counted where the result depends on them: a dead row that a
kernel need not touch costs nothing, a pair outside the stencil costs
nothing.
"""

#: float32 operations of one ordered pair inside the 27-cell stencil: the
#: 8 of the cell-delta test that admits it (3 sub, 3 mul, 2 add) and the 19
#: of its gravity term (3 sub, 3 mul, 3 add, one rsqrt, 3 mul, 3 fma)
PAIR_FLOPS = 27
#: bytes the pair pass reads of a live row (position 12, weight 4, age 4,
#: the collision key of its tag 4) and writes (force 12, collision key 4)
PAIR_ROW_BYTES = 24 + 16
#: bytes of an n-body slot's state: pos, vel, acc (12 each), w, age, life
#: (4 each), alive, parent (1 each), the tag's 32 bits (4)
NBODY_ROW_BYTES = 3 * 12 + 3 * 4 + 2 + 4


def pair_pass(pairs: int, alive_rows: int):
    """(flops, bytes) of one frame's pair pass."""
    return pairs * PAIR_FLOPS, alive_rows * PAIR_ROW_BYTES


def nbody_rows(rows: int):
    """Bytes of a frame's per-row work over ``rows`` stepped slots: the
    state read once and written once."""
    return 2 * rows * NBODY_ROW_BYTES


def emitter_physics(slots: int, alive: float, spawned: float,
                    window: int, n_fields: int = 8):
    """Bytes of one emitter frame's physics and spawn write on the packed
    fields: every slot's age and life read (is it alive?); a live row's
    other six fields read and its position, velocity and age written (its
    life does not change); the window's valid flags read and each valid
    row's fields read and written."""
    return (slots * 8 + alive * (6 * 4 + 7 * 4) + window
            + spawned * 2 * n_fields * 4)
