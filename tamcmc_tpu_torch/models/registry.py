"""Model registry: reference model names -> build functions (port of
tamcmc_tpu/models/registry.py; reference `Model_def::call_model`,
`models.cpp` [U]).

`build_model(name, spec)` resolves the name once, at setup, and returns a
plain torch `model_fn(params (..., D), nu (N,), fixed=None)` batched over
leading dims plus its BlockLayout; no string reaches the sampler loop.  This
is the port's one table of model names.
"""

from __future__ import annotations

import dataclasses

from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec, build_ms_global
from tamcmc_tpu_torch.models.local import (
    MSLocalSpec, build_ms_local, MSLocalHnlmSpec, build_ms_local_hnlm,
)
from tamcmc_tpu_torch.models.asymptotic import RGBAsymptSpec, build_rgb_asympt
from tamcmc_tpu_torch.models.ajfit import AjFitSpec, build_ajfit
from tamcmc_tpu_torch.ops.lorentzian_kernel import check_precision
from tamcmc_tpu_torch.models.test_models import (
    TestGaussianSpec, build_test_gaussian,
    HarveyGaussianSpec, build_harvey_gaussian,
    SingleLorentzianSpec, build_single_lorentzian,
    HarveyBackgroundSpec, build_harvey_background,
    Kallinger2014Spec, build_kallinger2014,
)


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    spec_cls: type
    build: object
    doc: str = ""


_WARNED_VARIANTS = set()


def _warn_variant_alias(name: str, variant: str):
    """Provenance note when a `_Classic`/`_vN` suffix is ALIASED AWAY.

    The mapping rests on the [U] belief that these reference variants differ
    only in `.model`-file IO conventions (`models.cpp` [U]); if any variant
    differs mathematically, a user running a reference setup would silently
    get the wrong model.  So say what happened, once per name, on stderr
    (the channel of the `.model` reader's banner)."""
    if name in _WARNED_VARIANTS:
        return
    _WARNED_VARIANTS.add(name)
    import sys
    print(f"note: model '{name}': the '_{variant}' suffix is treated as a "
          "mathematical ALIAS of the base model (reference variants are "
          "believed to differ only in .model-file IO conventions [U], "
          "not verified against the reference's source); if the "
          "reference's variant differs mathematically this fit uses the "
          "base-model math", file=sys.stderr)


_FAMILIES = {}


def _register(name, spec_cls, build, doc=""):
    """`build(spec, precision)` -> (model_fn, layout); `precision` is the
    Lorentzian profile stream's (ops/lorentzian.py)."""
    _FAMILIES[name.lower()] = ModelFamily(name, spec_cls, build, doc)


def _spec_only(build):
    """The build of a family without a Lorentzian sum: the profile
    precision changes nothing there, as in the reference."""
    return lambda spec, precision: build(spec)


_register("model_MS_Global_a1etaa3_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(spec, precision),
          "global p-mode fit, a1/eta0/a3 rotation, Harvey-like background")
_register("model_MS_Global_a1etaa3_HarveyLike_Classic", MSGlobalSpec,
          lambda spec, precision: (_warn_variant_alias(
              "model_MS_Global_a1etaa3_HarveyLike_Classic", "classic"),
              build_ms_global(spec, precision))[1],
          "alias of a1etaa3_HarveyLike (the reference's _Classic differs "
          "only in .model-file IO conventions [U])")
_register("model_MS_Global_a1etaa3_Harvey1985", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, noise_kind="harvey_1985"), precision),
          "a1etaa3 rotation with the classic Harvey (1985) noise profile")
_register("model_MS_Global_a1l_etaa3_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="a1l"), precision),
          "per-degree splittings a1(l=1), a1(l=2); l=3 uses their mean")
_register("model_MS_Global_a1n_etaa3_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="a1n"), precision),
          "per-radial-order splittings a1(n), shared across degrees")
_register("model_MS_Global_a1nl_etaa3_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="a1nl"), precision),
          "per-(order, degree) splittings: a1(n, l=1) and a1(n, l=2) tables")
_register("model_MS_Global_a1a2a3_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="a1a2a3"), precision),
          "a2 asphericity fitted directly instead of the centrifugal eta term")
_register("model_MS_Global_a1etaa3_AppWidth_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, width_kind="app2016"), precision),
          "a1etaa3 rotation with the Appourchaux+2016 width relation "
          "(6 relation params replace the N0 free widths)")
_register("model_MS_Global_aj_AppWidth_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="aj", width_kind="app2016"),
              precision),
          "a1..a6 a-coefficients with the Appourchaux+2016 width relation")
_register("model_MS_Global_aj_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="aj"), precision),
          "global p-mode fit, a1..a6 a-coefficients, Harvey-like background")
_register("model_MS_Global_ajAlm_HarveyLike", MSGlobalSpec,
          lambda spec, precision: build_ms_global(
              dataclasses.replace(spec, rotation="ajAlm"), precision),
          "global p-mode fit, odd aj + Alm activity asphericity")
_register("model_RGB_asympt_a1etaa3_HarveyLike", RGBAsymptSpec,
          build_rgb_asympt,
          "RGB/subgiant fit: individual l=0/2 + ARMM l=1 mixed-mode forest")
_register("model_RGB_asympt_a1etaa3_freeWidth_HarveyLike", RGBAsymptSpec,
          build_rgb_asympt,
          "alias: per-order free widths are this implementation's default")
_register("model_RGB_asympt_a1etaa3_AppWidth_HarveyLike", RGBAsymptSpec,
          lambda spec, precision: build_rgb_asympt(
              dataclasses.replace(spec, width_kind="app2016"), precision),
          "RGB/subgiant mixed-mode fit with the Appourchaux+2016 width "
          "relation on the p-mode ridge")
_register("model_ajfit", AjFitSpec, _spec_only(build_ajfit),
          "a-coefficient table fit: aj (j=1..6) + optional Alm activity "
          "asphericity to measured nu_nlm frequencies (io_ajfit [U]); "
          "Gaussian chi_square likelihood over the mode table, no spectrum")
_register("model_MS_local_basic", MSLocalSpec, build_ms_local,
          "windowed local fit, per-mode free parameters")
_register("model_MS_local_Hnlm", MSLocalHnlmSpec, build_ms_local_hnlm,
          "local fit with free azimuthal height ratios (magnetic stars)")
_register("model_Test_Gaussian", TestGaussianSpec,
          _spec_only(build_test_gaussian),
          "Gaussian bump + white noise (sampler smoke test)")
_register("model_Harvey_Gaussian", HarveyGaussianSpec,
          _spec_only(build_harvey_gaussian),
          "Harvey profile + Gaussian envelope")
_register("model_Single_Lorentzian", SingleLorentzianSpec,
          _spec_only(build_single_lorentzian), "BASELINE config 1")
_register("model_Harvey_Background", HarveyBackgroundSpec,
          _spec_only(build_harvey_background),
          "BASELINE config 2 noise-background fit")
_register("model_Kallinger2014_Gaussian", Kallinger2014Spec,
          _spec_only(build_kallinger2014),
          "Kallinger+2014 two-component granulation background + Gaussian "
          "p-mode envelope, sinc^2-apodised")


# ---------------------------------------------------------------------------
# Name combinator — the reference's model dictionary is COMBINATORIAL
# (`models.cpp` [U], its largest file): families are products of
# rotation law x width law x noise law x IO-variant suffix.  Rather than
# hand-registering every member, reference-style names are PARSED into spec
# overrides; the explicit registry above keeps curated docs/aliases and wins
# on exact match.
# ---------------------------------------------------------------------------

# rotation name segment -> MSGlobalSpec.rotation (reference spellings [U])
_ROT_SEGMENTS = {
    "a1etaa3": "a1etaa3",
    "a1a2a3": "a1a2a3",
    "a1l_etaa3": "a1l",
    "a1n_etaa3": "a1n",
    "a1nl_etaa3": "a1nl",
    "aj": "aj",
    "ajalm": "ajAlm",
}
_NOISE_SEGMENTS = {"harveylike": "harvey_like", "harvey1985": "harvey_1985"}
# IO-variant suffixes: the reference's _Classic/_vN differ only in
# .model-file IO conventions [U] — mathematical aliases here.  RGB _v2/_v3
# map to the per-mode mixed-mode freedom switches (models/asymptotic.py).
_VARIANT_SUFFIXES = ("classic", "v2", "v3", "v4")


def parse_model_name(name: str):
    """Parse a reference-style combinatorial model name into
    (family, spec_overrides, variant) or None if it doesn't match the
    grammar:

      model_MS_Global_<rot>[_AppWidth]_<noise>[_<variant>]
      model_RGB_asympt_<rot>[_freeWidth|_AppWidth]_<noise>[_<variant>]

    rot in {a1etaa3, a1a2a3, a1l_etaa3, a1n_etaa3, a1nl_etaa3, aj, ajAlm};
    noise in {HarveyLike, Harvey1985}; variant in {Classic, v2, v3, v4}
    (IO aliases for MS_Global; per-mode freedom switches for RGB).
    """
    low = name.strip().lower()
    for prefix, family in (("model_ms_global_", "ms_global"),
                           ("model_rgb_asympt_", "rgb_asympt")):
        if low.startswith(prefix):
            rest = low[len(prefix):]
            break
    else:
        return None
    variant = ""
    for suf in _VARIANT_SUFFIXES:
        if rest.endswith("_" + suf):
            variant = suf
            rest = rest[: -len(suf) - 1]
            break
    noise_kind = None
    for seg, kind in _NOISE_SEGMENTS.items():
        if rest.endswith("_" + seg):
            noise_kind = kind
            rest = rest[: -len(seg) - 1]
            break
    if noise_kind is None:
        return None
    width_kind = "free"
    if rest.endswith("_appwidth"):
        width_kind = "app2016"
        rest = rest[: -len("_appwidth")]
    elif rest.endswith("_freewidth"):
        rest = rest[: -len("_freewidth")]   # per-mode free widths = default
    rot = _ROT_SEGMENTS.get(rest)
    if rot is None:
        return None
    if family == "rgb_asympt":
        # the RGB families are a1etaa3-only in the reference's list [U]
        if rot != "a1etaa3":
            return None
        over = {"width_kind": width_kind, "noise_kind": noise_kind}
        if variant in ("v2", "v3", "v4"):
            # v2: per-mixed-mode height/width factor tables; v3+: + g-mode
            # frequency scatter (bump_DP _v2/_v3 RGB variants [U])
            over["per_mode"] = "hw" if variant == "v2" else "hw_scatter"
        return (family, over, variant)
    over = {"rotation": rot, "width_kind": width_kind,
            "noise_kind": noise_kind}
    return (family, over, variant)


def _combinator_names():
    """The full reference-style product (canonical capitalisation)."""
    names = []
    for rotseg in ("a1etaa3", "a1a2a3", "a1l_etaa3", "a1n_etaa3",
                   "a1nl_etaa3", "aj", "ajAlm"):
        for w in ("", "AppWidth"):
            for noise in ("HarveyLike", "Harvey1985"):
                mid = f"{rotseg}_{w}_{noise}" if w else f"{rotseg}_{noise}"
                names.append(f"model_MS_Global_{mid}")
    for w in ("", "freeWidth", "AppWidth"):
        for noise in ("HarveyLike", "Harvey1985"):
            for var in ("", "v2", "v3"):
                parts = ["model_RGB_asympt_a1etaa3"]
                if w:
                    parts.append(w)
                parts.append(noise)
                if var:
                    parts.append(var)
                names.append("_".join(parts))
    return names


def list_models():
    """Every buildable name: explicit registry entries plus the full
    combinatorial product (deduped case-insensitively; the reference's
    `models.cpp` dictionary is this product [U])."""
    seen, out = set(), []
    for n in sorted(f.name for f in _FAMILIES.values()) \
            + sorted(_combinator_names()):
        if n.lower() not in seen:
            seen.add(n.lower())
            out.append(n)
    return sorted(out)


def _resolve_family(name: str) -> ModelFamily:
    key = name.strip().lower()
    if key in _FAMILIES:
        return _FAMILIES[key]
    parsed = parse_model_name(name)
    if parsed is None:
        raise KeyError(f"unknown model '{name}'; have {list_models()}")
    family, over, variant = parsed
    # RGB v2/v3/v4 map to REAL per-mode freedom switches (over["per_mode"]);
    # everything else with a variant suffix is an alias: say so
    if variant and "per_mode" not in over:
        _warn_variant_alias(name, variant)
    if family == "ms_global":
        spec_cls, base = MSGlobalSpec, build_ms_global
    else:
        spec_cls, base = RGBAsymptSpec, build_rgb_asympt
    build = (lambda spec, precision, _b=base, _o=over:
             _b(dataclasses.replace(spec, **_o), precision))
    return ModelFamily(name, spec_cls, build,
                       doc=f"combinator: {family} with {over}"
                           + (f" (variant {variant})" if variant else ""))


def build_model(name: str, spec=None, precision: str = "f32",
                **spec_kwargs):
    """Build (model_fn, layout) for a named family.

    Either pass a ready spec dataclass, or kwargs for the family's spec
    class.  Names resolve through the explicit registry first, then the
    combinatorial grammar (parse_model_name) — any member of the reference's
    rotation x width x noise x variant product builds.  `precision` ("f32"
    | "bf16") is the Lorentzian profile stream of the families that sum
    Lorentzians (MS_Global, RGB, MS_local); the reference sets it
    process-wide instead (set_profile_precision).
    """
    fam = _resolve_family(name)
    if spec is None:
        spec = fam.spec_cls(**spec_kwargs)
    fn, layout = fam.build(spec, check_precision(precision))
    # introspection for tooling (Problem.model_meta); harmless on plain
    # closures
    try:
        fn._family_name = name
        fn._family_spec = spec
        fn._precision = precision
    except AttributeError:
        pass
    return fn, layout
