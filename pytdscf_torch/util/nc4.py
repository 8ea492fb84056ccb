"""netCDF4-compatible HDF5 writer (no netCDF4/h5netcdf dependency).

The reference exports time-dependent reduced densities as a netCDF4 file
with a compound ``complex128 {real, imag}`` type and per-mode grid
dimensions (``/root/reference/pytdscf/properties.py:156-209``).  The
netCDF4 format IS an HDF5 layout convention, so this module writes files
through h5py following the netcdf-c / h5netcdf on-disk rules:

* every dimension is an HDF5 *dimension scale* dataset carrying
  ``CLASS = b"DIMENSION_SCALE"``, a ``NAME`` of the canonical
  "This is a netCDF dimension but not a netCDF variable. <len>" form and a
  ``_Netcdf4Dimid`` id in creation order;
* unlimited dimensions are zero-length datasets with unlimited maxshape;
* data variables attach the scales (``DIMENSION_LIST``) and record
  ``_Netcdf4Coordinates``;
* the compound complex type is committed at the root as ``complex128``
  (what ``nc.Dataset.createCompoundType`` does);
* a ``_NCProperties`` root attribute marks the writer.

Files written here open with ``netCDF4.Dataset`` / xarray / h5netcdf.
``h5py`` is imported when a writer is made, not with the module, so the
port imports where h5py is missing and a ``reduced_density=`` request
there fails before any step runs.
"""

from __future__ import annotations

import numpy as np

COMPLEX128 = np.dtype([("real", np.float64), ("imag", np.float64)])
# netcdf-c's DIM_WITHOUT_VARIABLE marker: the exact string (no separator)
# followed by the length in a %10d field.
_DIM_NAME = "This is a netCDF dimension but not a netCDF variable.%10d"


class NC4Writer:
    """Minimal netCDF4-flavoured HDF5 writer (dims, vars, row appends)."""

    def __init__(self, path: str):
        global h5py
        import h5py  # here, not with the module: h5py may be missing
        self.path = path
        self._dim_order: list[str] = []
        self._var_dims: dict[str, tuple[str, ...]] = {}
        with h5py.File(path, "w") as f:
            f.attrs["_NCProperties"] = np.bytes_(
                b"version=2,pytdscf_torch=1"
            )

    # ------------------------------------------------------------- schema
    def create_dimension(self, name: str, size: int | None) -> None:
        """``size=None`` declares an unlimited (appendable) dimension."""
        with h5py.File(self.path, "a") as f:
            if size is None:
                d = f.create_dataset(
                    name, shape=(0,), maxshape=(None,), dtype="f4"
                )
                label = 0
            else:
                d = f.create_dataset(name, shape=(size,), dtype="f4")
                label = size
            d.make_scale(_DIM_NAME % label)  # sets CLASS + NAME
            d.attrs["_Netcdf4Dimid"] = np.int32(len(self._dim_order))
        self._dim_order.append(name)

    def create_variable(
        self, name: str, dtype, dims: tuple[str, ...]
    ) -> None:
        dtype = np.dtype(dtype)
        with h5py.File(self.path, "a") as f:
            if dtype.names and "complex128" not in f:
                f["complex128"] = COMPLEX128  # committed named type
            shape, maxshape = [], []
            for dn in dims:
                n = f[dn].shape[0]
                unlimited = f[dn].maxshape[0] is None
                shape.append(0 if unlimited else n)
                maxshape.append(None if unlimited else n)
            d = f.create_dataset(
                name, shape=tuple(shape), maxshape=tuple(maxshape),
                dtype=f["complex128"] if dtype.names else dtype,
            )
            for i, dn in enumerate(dims):
                d.dims[i].attach_scale(f[dn])
            d.attrs["_Netcdf4Coordinates"] = np.asarray(
                [self._dim_order.index(dn) for dn in dims], np.int32
            )
        self._var_dims[name] = dims

    # --------------------------------------------------------------- data
    def append_row(self, name: str, row: int, value) -> None:
        """Write ``value`` at index ``row`` of the variable's first
        (unlimited) dimension, growing it as needed."""
        with h5py.File(self.path, "a") as f:
            d = f[name]
            if d.shape[0] <= row:
                d.resize((row + 1,) + d.shape[1:])
                dim0 = self._var_dims[name][0]
                if f[dim0].shape[0] <= row:
                    f[dim0].resize((row + 1,))
            value = np.asarray(value)
            if d.dtype.names and value.dtype.kind == "c":
                out = np.empty(value.shape, COMPLEX128)
                out["real"] = value.real
                out["imag"] = value.imag
                value = out
            d[row] = value


def as_complex(arr: np.ndarray) -> np.ndarray:
    """Compound {real, imag} (or plain complex) array → complex ndarray."""
    arr = np.asarray(arr)
    if arr.dtype.names:
        return arr["real"] + 1.0j * arr["imag"]
    return arr
