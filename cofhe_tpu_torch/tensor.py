"""Lightweight n-D tensor of Python objects (plaintext ints / CipherTexts /
partial-decryption Forms).

The reference implements a ~1.2k-line strided/broadcast pointer-tensor
(common/tensor.hpp:18-1247) because C++ has no ergonomic n-D container; on
the host side of the TPU framework a flat list + shape is all that's needed
(the GPU compute path uses int32 limb tensors instead, see cofhe_tpu_torch/ops/).
API mirrors the reference surface: ndim/shape/num_elements/flatten/reshape/
at/broadcast.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Sequence


class Tensor:
    __slots__ = ("data", "shape")

    def __init__(self, data: Sequence[Any], shape: Sequence[int] | None = None):
        self.data = list(data)
        if shape is None:
            shape = (len(self.data),)
        self.shape = tuple(int(s) for s in shape)
        if math.prod(self.shape) != len(self.data):
            raise ValueError(f"shape {self.shape} does not match {len(self.data)} elements")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def full(shape: Sequence[int], value: Any) -> "Tensor":
        return Tensor([value] * math.prod(shape), shape)

    @staticmethod
    def zero_degree(value: Any) -> "Tensor":
        """0-D scalar tensor (reference tensor.hpp:1109)."""
        return Tensor([value], ())

    @staticmethod
    def from_nested(nested: Any) -> "Tensor":
        shape = []
        probe = nested
        while isinstance(probe, (list, tuple)):
            shape.append(len(probe))
            probe = probe[0]
        flat: list[Any] = []

        def rec(x, depth):
            if depth == len(shape):
                flat.append(x)
                return
            if len(x) != shape[depth]:
                raise ValueError("ragged nested list")
            for e in x:
                rec(e, depth + 1)

        rec(nested, 0)
        return Tensor(flat, shape)

    # -- shape ops ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_elements(self) -> int:
        return len(self.data)

    def is_zero_degree(self) -> bool:
        return self.shape == ()

    def get_value(self) -> Any:
        if not self.is_zero_degree() and self.num_elements != 1:
            raise ValueError("not a scalar tensor")
        return self.data[0]

    def reshape(self, shape: Sequence[int]) -> "Tensor":
        return Tensor(self.data, shape)

    def flatten(self) -> "Tensor":
        return Tensor(self.data, (len(self.data),))

    def at(self, *idx: int) -> Any:
        if len(idx) != max(self.ndim, 1):
            raise IndexError("wrong index arity")
        flat = 0
        shape = self.shape or (1,)
        for i, s in zip(idx, shape):
            if not 0 <= i < s:
                raise IndexError(f"index {idx} out of bounds for {shape}")
            flat = flat * s + i
        return self.data[flat]

    def __getitem__(self, i: int) -> Any:
        return self.data[i]

    def __iter__(self) -> Iterable[Any]:
        return iter(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Tensor) and self.shape == other.shape and self.data == other.data

    def set(self, *args: Any) -> None:
        """set(i, j, ..., value): write one element in place (the reference
        Accessor's set, common/tensor.hpp)."""
        *idx, value = args
        flat = 0
        shape = self.shape or (1,)
        if len(idx) != max(self.ndim, 1):
            raise IndexError("wrong index arity")
        for i, s in zip(idx, shape):
            if not 0 <= i < s:
                raise IndexError(f"index {idx} out of bounds for {shape}")
            flat = flat * s + i
        self.data[flat] = value

    def section(self, starts: Sequence[int], ends: Sequence[int]
                ) -> "TensorView":
        """Strided VIEW of the rectangular sub-box [starts, ends) sharing
        this tensor's storage — the reference Accessor's walk/section view
        machinery (common/tensor.hpp:112-193, 462-1095). Writes through the
        view are visible in the parent."""
        if len(starts) != self.ndim or len(ends) != self.ndim:
            raise ValueError("starts/ends arity must match ndim")
        for s, e, d in zip(starts, ends, self.shape):
            if not 0 <= s <= e <= d:
                raise ValueError(f"bad section [{starts}, {ends}) of {self.shape}")
        strides = []
        acc = 1
        for d in reversed(self.shape):
            strides.append(acc)
            acc *= d
        strides.reverse()
        offset = sum(s * st for s, st in zip(starts, strides))
        shape = tuple(e - s for s, e in zip(starts, ends))
        return TensorView(self.data, shape, tuple(strides), offset)

    def broadcast_view(self, shape: Sequence[int]) -> "TensorView":
        """Broadcast VIEW (stride-0 on expanded axes) — the reference's
        broadcast accessor (tensor.hpp: broadcast_degree indexing)."""
        shape = tuple(int(s) for s in shape)
        pad = len(shape) - self.ndim
        if pad < 0:
            raise ValueError("cannot broadcast to fewer dims")
        strides = []
        acc = 1
        for d in reversed(self.shape):
            strides.append(acc)
            acc *= d
        strides.reverse()
        src_shape = (1,) * pad + self.shape
        src_strides = (0,) * pad + tuple(strides)
        out_strides = []
        for d, (sd, st) in zip(shape, zip(src_shape, src_strides)):
            if sd == d:
                out_strides.append(st)
            elif sd == 1:
                out_strides.append(0)
            else:
                raise ValueError(f"cannot broadcast {self.shape} to {shape}")
        return TensorView(self.data, shape, tuple(out_strides), 0)

    def map(self, fn: Callable[[Any], Any]) -> "Tensor":
        return Tensor([fn(x) for x in self.data], self.shape)

    def zip_map(self, other: "Tensor", fn: Callable[[Any, Any], Any]) -> "Tensor":
        a, b = broadcast_pair(self, other)
        return Tensor([fn(x, y) for x, y in zip(a.data, b.data)], a.shape)

    def tolist(self) -> Any:
        def build(dim: int, offset: int, stride: int):
            if dim == self.ndim:
                return self.data[offset]
            size = self.shape[dim]
            inner = stride // size if size else 0
            return [build(dim + 1, offset + i * inner, inner) for i in range(size)]

        return build(0, 0, len(self.data))

    def __repr__(self) -> str:
        return f"Tensor(shape={self.shape}, data[0]={self.data[0]!r}...)" if self.data else "Tensor([])"


class TensorView:
    """Non-owning strided view over a Tensor's storage (the reference's
    Accessor, common/tensor.hpp:462-1095): at/set map through strides, so
    non-contiguous sections and stride-0 broadcasts work without copying.
    `make_contiguous()` materializes a fresh Tensor."""

    __slots__ = ("storage", "shape", "strides", "offset")

    def __init__(self, storage: list, shape: tuple[int, ...],
                 strides: tuple[int, ...], offset: int):
        self.storage = storage
        self.shape = shape
        self.strides = strides
        self.offset = offset

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape)

    def is_contiguous(self) -> bool:
        acc = 1
        for d, st in zip(reversed(self.shape), reversed(self.strides)):
            if d != 1 and st != acc:
                return False
            acc *= d
        return True

    def is_broadcasted(self) -> bool:
        return any(st == 0 and d > 1
                   for d, st in zip(self.shape, self.strides))

    def _flat(self, idx: Sequence[int]) -> int:
        if len(idx) != self.ndim:
            raise IndexError("wrong index arity")
        off = self.offset
        for i, (d, st) in zip(idx, zip(self.shape, self.strides)):
            if not 0 <= i < d:
                raise IndexError(f"index {idx} out of bounds for {self.shape}")
            off += i * st
        return off

    def at(self, *idx: int) -> Any:
        return self.storage[self._flat(idx)]

    def set(self, *args: Any) -> None:
        *idx, value = args
        self.storage[self._flat(idx)] = value

    def __iter__(self) -> Iterable[Any]:
        def rec(dim: int, off: int):
            if dim == self.ndim:
                yield self.storage[off]
                return
            for i in range(self.shape[dim]):
                yield from rec(dim + 1, off + i * self.strides[dim])

        return rec(0, self.offset)

    def make_contiguous(self) -> Tensor:
        return Tensor(list(self), self.shape)

    def section(self, starts: Sequence[int], ends: Sequence[int]
                ) -> "TensorView":
        for s, e, d in zip(starts, ends, self.shape):
            if not 0 <= s <= e <= d:
                raise ValueError(f"bad section [{starts}, {ends}) of {self.shape}")
        off = self.offset + sum(s * st for s, st in zip(starts, self.strides))
        shape = tuple(e - s for s, e in zip(starts, ends))
        return TensorView(self.storage, shape, self.strides, off)


def broadcast_pair(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Numpy-style broadcasting of two object tensors."""
    if a.shape == b.shape:
        return a, b
    sa = (1,) * (max(a.ndim, b.ndim) - a.ndim) + a.shape
    sb = (1,) * (max(a.ndim, b.ndim) - b.ndim) + b.shape
    out_shape = []
    for x, y in zip(sa, sb):
        if x != y and 1 not in (x, y):
            raise ValueError(f"cannot broadcast {a.shape} with {b.shape}")
        out_shape.append(max(x, y))
    out_shape = tuple(out_shape)

    def expand(t: Tensor, s: tuple[int, ...]) -> Tensor:
        if s == out_shape:
            return Tensor(t.data, out_shape)
        out = []
        strides = []
        acc = 1
        for dim in reversed(s):
            strides.append(acc)
            acc *= dim
        strides.reverse()
        for flat in range(math.prod(out_shape)):
            idx = []
            rem = flat
            for d in range(len(out_shape) - 1, -1, -1):
                idx.append(rem % out_shape[d])
                rem //= out_shape[d]
            idx.reverse()
            src = 0
            for d in range(len(s)):
                i = idx[d] if s[d] != 1 else 0
                src += i * strides[d]
            out.append(t.data[src])
        return Tensor(out, out_shape)

    return expand(Tensor(a.data, sa), sa), expand(Tensor(b.data, sb), sb)
