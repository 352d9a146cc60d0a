"""Physical constants and asteroseismic scaling relations.

Centralised so every parity-sensitive constant lives in one place.  Values
follow the standard CGS conventions used by the asteroseismology literature
underlying the reference (Benomar et al. 2009; reference file
`tamcmc/sources/function_rot.cpp` [U] — see SURVEY.md provenance note: the
reference mount was empty, so constants must be re-grounded against the C++
source when it becomes readable).
"""

import math

# CGS
G_CGS = 6.667e-8          # gravitational constant [cm^3 g^-1 s^-2]
RHO_SUN = 1.408           # mean solar density [g cm^-3]
DNU_SUN = 135.1           # solar large separation [uHz]
NUMAX_SUN = 3150.0        # solar nu_max [uHz]
TEFF_SUN = 5777.0         # [K]

# Target acceptance rate for the adaptive proposal (Atchade 2006; the
# classic d->inf optimal-scaling value for Metropolis).
TARGET_ACCEPTANCE = 0.234


def rho_from_dnu(dnu_uhz: float) -> float:
    """Mean stellar density [g cm^-3] from the Delta-nu scaling relation:
    rho/rho_sun = (Dnu/Dnu_sun)^2."""
    return RHO_SUN * (dnu_uhz / DNU_SUN) ** 2


def eta0_from_dnu(dnu_uhz: float) -> float:
    """Centrifugal-distortion coefficient eta0 [s^2].

    delta_nu(centrifugal) = eta0 * (a1[Hz])^2 * nu * Q_lm  with
    eta0 = 3*pi / (G * rho): derived from delta_nu/nu ~ (4pi/3) Omega^2/(G rho)
    * Q_lm with Omega = 2*pi*a1.  Matches the eta0 ~ 3/(4 pi rho G) * (2 pi)^2
    / ... convention of the reference's `eta0` calculation in
    function_rot.cpp [U]; re-ground on reference availability.
    """
    return 3.0 * math.pi / (G_CGS * rho_from_dnu(dnu_uhz))
