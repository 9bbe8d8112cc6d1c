"""Minimal NetCDF interface (read + write) on top of scipy / h5py.

Counterpart of the JAX package's ``utils/ncio.py`` with the same
``NcReader`` / ``NcWriter`` API.  The writer produces classic NetCDF (CDF-2,
``scipy.io.netcdf_file``), so the same files come out on a machine without
``h5py``.  The reader takes classic files through scipy and NetCDF4 (HDF5)
files through ``h5py`` when it is importable.

Classic NetCDF has no 64-bit integers and no booleans: the writer stores
both as 32-bit integers.  Character arrays are stored as ``char``.  A
dimension gets a variable of its own only where a caller writes one.

Classic NetCDF has no groups either, and a classic name may not contain
``/``.  A group's variables are stored there under the prefixed name
``<group>.<variable>`` (``camera-settings.px``); :meth:`NcReader.group`
reads that form from a classic file and the HDF5 group of a NetCDF4 file.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

try:
    import h5py
except ImportError:  # the card's machine has no h5py
    h5py = None

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
GROUP_SEP = "."     # <group>.<variable>: a group's variable in a classic file


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _HDF5_MAGIC


def decode_strings(arr) -> np.ndarray:
    """Decode a NetCDF char array (..., string_len) of S1 into str objects."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 1 and arr.ndim >= 1:
        flat = arr.reshape(-1, arr.shape[-1])
        out = np.array(
            [b"".join(row).decode("ascii", "replace").strip("\x00").strip()
             for row in flat], dtype=object)
        return out.reshape(arr.shape[:-1])
    if arr.dtype.kind == "S":
        return np.array([s.decode("ascii", "replace").strip()
                         for s in arr.reshape(-1)],
                        dtype=object).reshape(arr.shape)
    return arr


def _h5_dim_names(ds) -> list:
    names = []
    for i in range(ds.ndim):
        dim = ds.dims[i]
        names.append(dim[0].name.rsplit("/", 1)[-1] if len(dim) else None)
    return names


class NcReader:
    """Read-only NetCDF handle (classic via scipy, NetCDF4/HDF5 via h5py)."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = self._sp = None
        if _is_hdf5(path):
            if h5py is None:
                raise RuntimeError(
                    f"{path} is a NetCDF4 (HDF5) file and h5py is not "
                    "installed; rewrite it as classic NetCDF")
            self._h5 = h5py.File(path, "r")
        else:
            self._sp = netcdf_file(path, "r", mmap=False)

    def has(self, name: str) -> bool:
        if self._h5 is not None:
            return name in self._h5 and isinstance(self._h5[name], h5py.Dataset)
        return name in self._sp.variables

    def dim(self, name: str) -> int:
        """Dimension size by name."""
        if self._h5 is not None:
            if name in self._h5:
                ds = self._h5[name]
                if ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE" or ds.ndim == 1:
                    return ds.shape[0]
            for ds in self._h5.values():
                if isinstance(ds, h5py.Dataset):
                    for i, dimname in enumerate(_h5_dim_names(ds)):
                        if dimname == name:
                            return ds.shape[i]
            raise KeyError(f"dimension {name!r} not found in {self.path}")
        if name not in self._sp.dimensions:
            raise KeyError(f"dimension {name!r} not found in {self.path}")
        size = self._sp.dimensions[name]
        if size is None:   # unlimited: measure it from a variable
            for var in self._sp.variables.values():
                if name in var.dimensions:
                    return var.shape[var.dimensions.index(name)]
        return size

    def read(self, name: str, dtype=None) -> np.ndarray:
        if self._h5 is not None:
            arr = np.asarray(self._h5[name][()])
        else:
            # Classic files are big-endian: hand out native byte order.
            data = self._sp.variables[name][...]
            arr = np.asarray(data, dtype=data.dtype.newbyteorder("="))
        if arr.dtype.kind in "SU":
            return arr
        return arr.astype(dtype) if dtype is not None else arr

    def read_strings(self, name: str) -> list:
        return list(decode_strings(self.read(name)).reshape(-1))

    def read_scalar(self, name: str, dtype=float):
        return dtype(np.asarray(self.read(name)).reshape(-1)[0])

    def read_optional(self, name: str, dtype=None):
        return self.read(name, dtype) if self.has(name) else None

    def variables(self) -> Iterable[str]:
        if self._h5 is not None:
            return [k for k, v in self._h5.items() if isinstance(v, h5py.Dataset)]
        return list(self._sp.variables)

    @property
    def is_hdf5(self) -> bool:
        return self._h5 is not None

    def has_group(self, name: str) -> bool:
        """Whether the file holds group ``name``: an HDF5 group, or in a
        classic file any variable ``<name>.<variable>``."""
        if self._h5 is not None:
            return name in self._h5 and isinstance(self._h5[name], h5py.Group)
        prefix = name + GROUP_SEP
        return any(v.startswith(prefix) for v in self._sp.variables)

    def group(self, name: str) -> "NcGroup":
        """A read view of group ``name`` (either form)."""
        if not self.has_group(name):
            raise KeyError(f"group {name!r} not found in {self.path}")
        return NcGroup(self, name)

    def close(self):
        (self._h5 if self._h5 is not None else self._sp).close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NcGroup:
    """The variables of one group of an open :class:`NcReader`: the HDF5
    group's datasets, or a classic file's ``<group>.<variable>``."""

    def __init__(self, reader: NcReader, name: str):
        self._reader = reader
        self.name = name
        self._sep = "/" if reader.is_hdf5 else GROUP_SEP

    def _full(self, var: str) -> str:
        return self.name + self._sep + var

    def has(self, var: str) -> bool:
        return self._reader.has(self._full(var))

    def read(self, var: str, dtype=None) -> np.ndarray:
        return self._reader.read(self._full(var), dtype)

    def read_scalar(self, var: str, dtype=float):
        return self._reader.read_scalar(self._full(var), dtype)

    def variables(self) -> list:
        if self._reader.is_hdf5:
            grp = self._reader._h5[self.name]
            return [k for k, v in grp.items() if isinstance(v, h5py.Dataset)]
        prefix = self.name + GROUP_SEP
        return [v[len(prefix):] for v in self._reader.variables()
                if v.startswith(prefix)]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def set_scalars(path: str, values: dict, group: Optional[str] = None) -> None:
    """Create or overwrite float64 scalar variables of an existing file,
    in its own format: a NetCDF4 (HDF5) file through ``h5py`` (in HDF5
    group ``group``), a classic file in place (as ``<group>.<name>``)."""
    if _is_hdf5(path):
        if h5py is None:
            raise RuntimeError(f"{path} is a NetCDF4 (HDF5) file and h5py "
                               "is not installed")
        with h5py.File(path, "r+") as f:
            root = f.require_group(group) if group else f
            for k, v in values.items():
                if k in root:
                    root[k][...] = v
                else:
                    root.create_dataset(k, data=np.float64(v))
        return
    with netcdf_file(path, "a", mmap=False) as f:
        for k, v in values.items():
            name = group + GROUP_SEP + k if group else k
            var = f.variables.get(name)
            if var is None:
                var = f.createVariable(name, "f8", ())
            var[...] = v


def _classic(data: np.ndarray) -> np.ndarray:
    """Cast to a type classic NetCDF stores: 64-bit and boolean integers
    become int32 (refused when a value does not fit)."""
    if data.dtype.kind == "b":
        return data.astype(np.int32)
    if data.dtype.kind == "u" or (data.dtype.kind == "i" and data.dtype.itemsize > 4):
        i32 = np.iinfo(np.int32)
        if data.size and (data.min() < i32.min or data.max() > i32.max):
            raise ValueError("integer values do not fit in classic NetCDF's int32")
        return data.astype(np.int32)
    return data


class NcWriter:
    """Write classic NetCDF (CDF-2) files.

    Usage::

        with NcWriter(path) as nc:
            nc.def_dim("lay", 60)
            nc.write("p_lay", data, ("lay", "col"))
            nc.write_strings("gas_names", names, "absorber", string_len=32)
    """

    def __init__(self, path: str):
        if os.path.exists(path):
            os.remove(path)
        self._nc = netcdf_file(path, "w", version=2)
        self._dims: Dict[str, int] = {}

    def def_dim(self, name: str, size: int):
        if name in self._dims:
            if self._dims[name] != size:
                raise ValueError(f"dim {name} redefined: {size} "
                                 f"(was {self._dims[name]})")
            return
        self._dims[name] = int(size)
        self._nc.createDimension(name, int(size))

    def write(self, name: str, data, dims: Sequence[str],
              attrs: Optional[dict] = None):
        data = _classic(np.asarray(data))
        if data.ndim != len(dims):
            raise ValueError(f"{name}: {data.shape} vs dims {tuple(dims)}")
        for d, s in zip(dims, data.shape):
            self.def_dim(d, s)
        var = self._nc.createVariable(name, data.dtype, tuple(dims))
        var[...] = data
        for k, v in (attrs or {}).items():
            setattr(var, k, v)

    def write_scalar(self, name: str, value, dtype="f8"):
        self.write(name, np.asarray(value, dtype=dtype), ())

    def write_strings(self, name: str, strings: Sequence[str], dim: str,
                      string_len: int = 32):
        self.def_dim(dim, len(strings))
        self.def_dim("string_len", string_len)
        arr = np.zeros((len(strings), string_len), dtype="S1")
        for i, s in enumerate(strings):
            b = s.encode("ascii")[:string_len]
            arr[i, :len(b)] = np.frombuffer(b, dtype="S1")
        self.write(name, arr, (dim, "string_len"))

    def close(self):
        self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
