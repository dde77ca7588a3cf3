"""Host-side RNG with bit parity to the reference's board generator.

The reference seeds boards with ``std::mt19937_64`` and draws cells through
libstdc++'s ``std::uniform_int_distribution`` (pomcpp src/bboard/bboard.cpp:
345-348, 365-366).  Bit-exact board parity therefore needs both pieces
reimplemented host-side: the MT19937-64 generator itself and libstdc++'s
*downscaling* algorithm (rejection sample below ``range * floor(2^64-1 /
range)`` then divide), which is implementation-defined by the C++ standard.

Counterpart of ``pomcpp_tpu.core.rng``, pure Python.  It runs on the host
only, for the exact board generator (``core.board_gen.init_state_np``) and
the parity tests; batched resets draw from Philox on the device.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

_NN = 312
_MM = 156
_MATRIX_A = 0xB5026F5AA96619E9
_UPPER_MASK = 0xFFFFFFFF80000000
_LOWER_MASK = 0x7FFFFFFF


class MT19937_64:
    """The 64-bit Mersenne Twister, matching ``std::mt19937_64``."""

    def __init__(self, seed: int = 5489):
        mt = [0] * _NN
        mt[0] = seed & _MASK64
        for i in range(1, _NN):
            prev = mt[i - 1]
            mt[i] = (6364136223846793005 * (prev ^ (prev >> 62)) + i) & _MASK64
        self._mt = mt
        self._mti = _NN

    def _twist(self) -> None:
        mt = self._mt
        for i in range(_NN):
            x = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _NN] & _LOWER_MASK)
            mt[i] = mt[(i + _MM) % _NN] ^ (x >> 1) ^ (_MATRIX_A if x & 1 else 0)
        self._mti = 0

    def __call__(self) -> int:
        if self._mti >= _NN:
            self._twist()
        y = self._mt[self._mti]
        self._mti += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & _MASK64


class UniformIntDistribution:
    """libstdc++'s ``std::uniform_int_distribution<int>`` over a 64-bit urng.

    Implements the GCC downscaling branch (bits/uniform_int_dist.h): with
    urng range 2^64-1 and target range ``n = b - a + 1``,
    ``scaling = floor((2^64 - 1) / n)``, rejection-sample raw draws below
    ``n * scaling``, and return ``raw // scaling + a``.
    """

    def __init__(self, a: int, b: int):
        assert b >= a
        self.a = a
        self.b = b
        n = b - a + 1
        self._scaling = _MASK64 // n
        self._past = n * self._scaling

    def __call__(self, rng: MT19937_64) -> int:
        while True:
            raw = rng()
            if raw < self._past:
                return raw // self._scaling + self.a
