"""Invisible watermark: embed and decode a byte string in uint8 images; a
numpy copy of the JAX package's `utils/watermark.py`, byte for byte the
same images.

The message bits are written, repeated, into the least-significant bit of
the blue channel over a pseudo-random pixel permutation from
`np.random.RandomState(0x5D1FFB17)`, and decoded by majority vote.  A pixel
moves by at most 1/255, and the mark survives a PNG round trip (lossless).
"""
from __future__ import annotations

import numpy as np

_SEED = 0x5D1FFB17


def _bits(message: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(message, dtype=np.uint8))


def embed_watermark(image: np.ndarray, message: str = "SDV1") -> np.ndarray:
    """[H, W, 3] uint8 -> a watermarked copy; raises if the image has fewer
    pixels than the message has bits."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"expected an [H, W, 3] uint8 image, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    bits = _bits(message.encode())
    n = h * w
    reps = n // len(bits)
    if reps == 0:
        raise ValueError("image too small for message")
    perm = np.random.RandomState(_SEED).permutation(n)[: reps * len(bits)]
    out = image.copy()
    blue = out[..., 2].reshape(-1)
    blue[perm] = (blue[perm] & 0xFE) | np.tile(bits, reps)
    out[..., 2] = blue.reshape(h, w)
    return out


def decode_watermark(image: np.ndarray, message_len: int = 4) -> str:
    """Majority-vote decode of a `message_len`-byte watermark."""
    h, w, _ = image.shape
    n = h * w
    nbits = message_len * 8
    reps = n // nbits
    perm = np.random.RandomState(_SEED).permutation(n)[: reps * nbits]
    payload = (image[..., 2].reshape(-1)[perm] & 1).reshape(reps, nbits)
    bits = (payload.mean(axis=0) > 0.5).astype(np.uint8)
    return np.packbits(bits).tobytes().decode(errors="replace")
