"""Physical unit conversions (CODATA 2018, via scipy.constants).

Conventions follow ``xxx_in_yyy = z`` meaning ``1 [xxx] = z [yyy]``.

Parity reference: ``PyTDSCF:pytdscf/units.py`` (values derived from the
same scipy physical_constants tables so all conversion factors agree bitwise).
"""

from scipy.constants import physical_constants as _pc

#: 1 Hartree in cm^-1
au_in_cm1 = (
    _pc["atomic unit of energy"][0]
    / (_pc["speed of light in vacuum"][0] * 1.0e02)
    / _pc["Planck constant"][0]
)
Hartree_in_cm1 = au_in_cm1

#: 1 atomic unit of time in femtoseconds
au_in_fs = _pc["atomic unit of time"][0] / 1.0e-15

#: 1 Hartree in eV
au_in_eV = _pc["Hartree energy in eV"][0]
Has_in_eV = au_in_eV

#: 1 electron mass in Dalton
au_in_dalton = _pc["electron mass"][0] / _pc["atomic mass constant"][0]
au_in_AMU = au_in_dalton

#: 1 Bohr in Angstrom
au_in_angstrom = _pc["Bohr radius"][0] / 1.0e-10
Bohr_in_angstrom = au_in_angstrom

#: 1 atomic unit of electric dipole moment in Debye
au_in_debye = (
    _pc["atomic unit of electric dipole mom."][0]
    * _pc["speed of light in vacuum"][0]
    * 1.0e21
)
