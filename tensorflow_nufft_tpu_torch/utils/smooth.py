"""Smooth-integer utilities for FFT-friendly grid sizing.

The fine (oversampled) grid dimensions are rounded up to even integers
whose prime factors are no larger than 5, so that the FFT stage is fast.
Behavioral parity with the reference's ``next_smooth_integer``
(reference: cc/kernels/nufft_plan.h:628-649), re-implemented from the
mathematical definition.
"""


def _is_5_smooth(n: int) -> bool:
    """True if ``n`` has no prime factors larger than 5."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def next_smooth_integer(n: int, multiple_of: int = 1) -> int:
    """Returns the smallest even 5-smooth integer ``>= n``.

    If ``multiple_of`` is given, the result is additionally a multiple of it
    (``multiple_of`` must itself be 5-smooth for termination).

    Args:
        n: Lower bound (any integer; values below 2 return 2).
        multiple_of: Optional divisibility requirement.

    Returns:
        The smallest even integer ``p >= max(n, 2)`` such that ``p`` is
        5-smooth and ``p % multiple_of == 0``.
    """
    if multiple_of > 1 and not _is_5_smooth(multiple_of):
        raise ValueError(
            f"multiple_of must be 5-smooth, got {multiple_of}")
    if n <= 2:
        n = 2
    if n % 2 == 1:
        n += 1
    p = n
    while not (_is_5_smooth(p) and p % multiple_of == 0):
        p += 2
    return p
