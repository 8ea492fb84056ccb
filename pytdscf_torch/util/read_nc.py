"""Read exported reduced densities.

API parity with the reference's netCDF reader
(``PyTDSCF:pytdscf/util/read_nc.py``).  The export is genuine
netCDF4 on-disk layout (``util/nc4.py``): compound ``{real, imag}``
``rho_{key}_{istate}`` variables over ``step``/``Q{idof}`` dimensions.
Reads both that and the legacy plain-complex HDF5 layout through h5py,
which is imported when a file is read, not with the module (as in
``util/nc4.py``): the port imports where h5py is missing.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch.util.nc4 import as_complex


def read_nc(
    path: str, keys: list[tuple[int, ...]], istate: int = 0
) -> dict[tuple[int, ...], np.ndarray]:
    """Return ``{key: array(steps, dims…)}`` of complex reduced densities."""
    import h5py  # here, not with the module: h5py may be missing

    out: dict[tuple[int, ...], np.ndarray] = {}
    with h5py.File(path, "r") as f:
        for key in keys:
            out[key] = as_complex(np.asarray(f[f"rho_{key}_{istate}"]))
        out["time"] = np.asarray(f["time"])
    return out
