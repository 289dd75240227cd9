"""7-smooth size planning (pure Python; counterpart of
vkresample_tpu/core/smooth.py).

The reference's FFT scheduler factorizes every axis into primes {2,3,5,7}
and errors on anything else (vkFFT.h:4716-4726; CLI help
VkResample.cpp:1813).  ``plan_factors`` groups the primes into composite
factors of at most ``max_factor``, the same planning the JAX package uses.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

_SMOOTH_PRIMES = (2, 3, 5, 7)


def factorize_7smooth(n: int) -> List[int]:
    """Prime factorization into {2,3,5,7}; raises on other primes."""
    if n < 1:
        raise ValueError(f"size must be >= 1, got {n}")
    factors: List[int] = []
    m = n
    for p in _SMOOTH_PRIMES:
        while m % p == 0:
            factors.append(p)
            m //= p
    if m != 1:
        raise ValueError(
            f"size {n} is not 7-smooth (leftover prime factor {m}); "
            "output dimensions must be products of 2, 3, 5 and 7"
        )
    return factors


def is_7smooth(n: int) -> bool:
    try:
        factorize_7smooth(n)
        return True
    except ValueError:
        return False


@lru_cache(maxsize=None)
def plan_factors(n: int, max_factor: int = 128) -> Tuple[int, ...]:
    """Split n into 7-smooth composite factors, each <= max_factor,
    greedy largest-first, sorted largest-first (2048 -> (128, 16))."""
    factorize_7smooth(n)  # validate
    if n == 1:
        return (1,)
    out: List[int] = []
    m = n
    while m > 1:
        if m <= max_factor:
            out.append(m)
            break
        best = 1
        for d in range(min(max_factor, m), 1, -1):
            if m % d == 0:
                best = d
                break
        if best == 1:  # cannot happen for 7-smooth m > max_factor >= 7
            raise ValueError(f"cannot factor {n} with max_factor={max_factor}")
        out.append(best)
        m //= best
    out.sort(reverse=True)
    return tuple(out)
