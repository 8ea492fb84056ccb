"""Spectrum post-processing: autocorrelation → FFT → IR / power spectrum.

A copy of the JAX package's ``spectra.py``, with the dat formats, window
functions, resampling and sign/shift conventions of upstream PyTDSCF's
``pytdscf/spectra.py``, so spectra are numerically interchangeable: load the
``autocorr.dat`` written by :class:`~pytdscf_torch.properties.Properties`,
window it (cos/cos²), resample to a uniform grid by cubic interpolation,
FFT, and report wavenumber vs intensity (·ω for absorption, with optional
ZPE shift).  The plots import matplotlib when called.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate

from pytdscf_torch import units

#: cm of light travel per fs, for fs-frequency → wavenumber conversion.
_FS_TO_CM1 = 1.0e15 * 3.33564e-11
#: How far a(0) may sit from 1.  A complex64 run (the card's default)
#: contracts a(0) = ⟨Ψ*|Ψ⟩ in float32 through every site, whose gauge
#: holds to ~1e-7 a site: on the H100 0.99999994 for H2O (3 sites) and
#: 0.9999983 for butadiene (14); the JAX package's 1e-8 refuses every
#: such file (ROADMAP C5).
A0_TOL = 1.0e-05


def load_autocorr(dat_file: str) -> tuple[np.ndarray, np.ndarray]:
    """Read (time [fs], a(t)) from a two-column autocorrelation dat file."""
    with open(dat_file) as f:
        header = f.readline()
        if "fs" not in header:
            import warnings

            warnings.warn(f"{dat_file}: time unit does not look like fs")
        data = np.loadtxt(f, usecols=(0, 1), dtype=np.complex128)
    time_fs = data[:, 0].real
    autocorr = data[:, 1]
    if time_fs[0] != 0.0:
        raise ValueError(f"autocorr must start at t=0, got {time_fs[0]}")
    if abs(autocorr[0] - 1.0) > A0_TOL:
        raise ValueError(f"a(0) must be 1, got {autocorr[0]}")
    return time_fs, autocorr


def apply_window(
    time_fs: np.ndarray, autocorr: np.ndarray, window: str | None = "cos2"
) -> np.ndarray:
    """Damp the finite-time autocorrelation: cos²(πt/2T), cos, or none."""
    if window is None:
        return autocorr
    arg = np.pi * time_fs / time_fs[-1] / 2.0
    if window == "cos2":
        return autocorr * np.cos(arg) ** 2
    if window == "cos":
        return autocorr * np.cos(arg)
    raise ValueError(f"unknown window {window!r}")


def ifft_autocorr(
    time_fs: np.ndarray,
    autocorr: np.ndarray,
    E_shift: float = 0.0,
    window: str | None = "cos2",
    power: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """FFT the autocorrelation to a spectrum.

    Returns (wavenumber [cm⁻¹], intensity).  ``power=False`` gives the
    absorption spectrum I(ω) ∝ ω·Re∫a(t)e^{iωt}dt with the ``E_shift`` [eV]
    subtracted from the frequency axis (typically the ZPE); ``power=True``
    gives the raw power spectrum.
    """
    spline = interpolate.interp1d(time_fs, autocorr, kind="cubic")
    dt = float(np.amax(time_fs[1:-1] - time_fs[0:-2])) / 2.0
    n = int((time_fs[-1] - time_fs[0]) / dt)
    t_unif = np.arange(n) * dt
    a_unif = apply_window(t_unif, spline(t_unif), window)
    omega_cm1 = -np.fft.fftshift(np.fft.fftfreq(n, dt)) * _FS_TO_CM1
    amp = np.fft.fftshift(np.fft.fft(a_unif) * dt)
    omega_cm1 = np.flipud(omega_cm1)
    if power:
        return omega_cm1, np.flipud(amp.real)
    omega_cm1 = omega_cm1 - E_shift * units.au_in_cm1 / units.au_in_eV
    return omega_cm1, np.flipud(amp.real) * omega_cm1


def export_spectrum(
    wave_number: np.ndarray, intensity: np.ndarray,
    filename: str = "spectrum.dat",
) -> None:
    with open(filename, "w") as f:
        f.write("# wave_number[cm-1]\t intensity[arb. unit]\n")
        np.savetxt(
            f,
            np.column_stack([wave_number, intensity]),
            fmt="%15.8f",
            delimiter="\t",
        )


def plot_autocorr(
    time_fs: np.ndarray, autocorr: np.ndarray, gui: bool = True,
    filename: str | None = None,
):
    """|a(t)|, Re a(t), Im a(t) vs t; saves to file when given."""
    import matplotlib

    if not gui:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(time_fs, np.abs(autocorr), label="|a(t)|")
    ax.plot(time_fs, autocorr.real, label="Re a(t)", lw=0.8)
    ax.plot(time_fs, autocorr.imag, label="Im a(t)", lw=0.8)
    ax.set_xlabel("time [fs]")
    ax.set_ylabel("autocorrelation")
    ax.legend()
    if filename:
        fig.savefig(filename, dpi=150)
    if gui:
        plt.show()
    plt.close(fig)
    return fig


def plot_spectrum(
    wave_number: np.ndarray,
    intensity: np.ndarray,
    lower_bound: float = 0.0,
    upper_bound: float = 4000.0,
    show_in_eV: bool = False,
    show_in_nm: bool = False,
    normalize: bool = True,
    gui: bool = True,
    filename: str | None = None,
):
    """Plot the spectrum in cm⁻¹ (default), eV, or nm axes."""
    import matplotlib

    if not gui:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mask = (wave_number >= lower_bound) & (wave_number <= upper_bound)
    x = wave_number[mask]
    y = intensity[mask]
    if normalize and y.size and np.max(np.abs(y)) > 0:
        y = y / np.max(np.abs(y))
    xlabel = "wavenumber [cm$^{-1}$]"
    if show_in_eV:
        x = x / units.au_in_cm1 * units.au_in_eV
        xlabel = "energy [eV]"
    elif show_in_nm:
        with np.errstate(divide="ignore"):
            x = 1.0e7 / x
        xlabel = "wavelength [nm]"
    fig, ax = plt.subplots()
    ax.plot(x, y)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("intensity [arb. unit]")
    if filename:
        fig.savefig(filename, dpi=150)
    if gui:
        plt.show()
    plt.close(fig)
    return fig
