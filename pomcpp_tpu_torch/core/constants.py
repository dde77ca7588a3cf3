"""Game constants and cell/move encodings.

TPU-native re-design of the reference constants (pomcpp include/bboard.hpp:15-109).
Instead of the reference's bit-packed cell encoding (wood powerup flags in the low
bits, flame signatures in bits [3,16), agents at ``1<<24``), we decompose the board
into three small integer planes (see ``pomcpp_tpu.core.state``):

* ``board``      -- the cell *class* (one of the ``CELL_*`` codes below)
* ``hidden_pow`` -- the 2-bit powerup flag carried by WOOD and FLAME cells
* ``flame_sig``  -- the flame-owner signature (origin cell index) for FLAME cells

Plane decomposition beats bit twiddling on TPU: each plane is a flat ``int32[121]``
vector (121 pads to one 128-lane register row), and all classification predicates
become single compares instead of shift/mask chains.
"""

BOARD_SIZE = 11
NUM_CELLS = BOARD_SIZE * BOARD_SIZE  # 121; flat index = x + BOARD_SIZE * y

AGENT_COUNT = 4
MOVE_COUNT = 4  # directional moves (reference bboard.hpp:15)

BOMB_LIFETIME = 10
BOMB_DEFAULT_STRENGTH = 1
FLAME_LIFETIME = 4

MAX_BOMBS_PER_AGENT = 5
MAX_BOMBS = AGENT_COUNT * MAX_BOMBS_PER_AGENT  # 20 queue slots
MAX_FLAMES = MAX_BOMBS  # reference uses the same capacity (bboard.hpp:385)

# --- Moves (reference bboard.hpp:35-52; Move and Direction share values 0..4) ---
M_IDLE = 0
M_UP = 1     # y - 1
M_DOWN = 2   # y + 1
M_LEFT = 3   # x - 1
M_RIGHT = 4  # x + 1
M_BOMB = 5
NUM_MOVES = 6

# Displacement tables indexed by move/direction code.
MOVE_DX = (0, 0, 0, -1, 1, 0)
MOVE_DY = (0, -1, 1, 0, 0, 0)

# --- Cell classes (our plane encoding; reference Item enum bboard.hpp:54-71) ---
C_PASSAGE = 0
C_RIGID = 1
C_WOOD = 2
C_BOMB = 3
C_FLAME = 4
C_FOG = 5        # reserved (reference declares FOG but never places it)
C_EXTRABOMB = 6
C_INCRRANGE = 7
C_KICK = 8
C_AGENT0 = 10    # agents are C_AGENT0 + id (id in [0, 4))

# Powerup flag values (hidden_pow plane; reference FlagItem, bboard.cpp:182-189).
# flag 0 -> nothing, 1 -> EXTRABOMB, 2 -> INCRRANGE, 3 -> KICK.
# Note: the reference's board generator draws flags in [1, 4] and masks with 0b11,
# so a drawn 4 becomes flag 0 == "empty wood" (bboard.cpp:368, bboard.hpp:106-108).
