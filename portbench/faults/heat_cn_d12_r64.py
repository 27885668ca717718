"""Faults planted under the timed path of ``heat_cn_d12_r64``, each of
which the check has to catch: ``FAULTS[name] = (attribute of the driver,
wrapper of it)``."""


def unchanged_step(make):
    """Every step runs and returns its input state, not its result."""
    def patched(*args, **kwargs):
        step, pack, unpack = make(*args, **kwargs)

        def faulty(u):
            step(u)
            return u.clone()
        return faulty, pack, unpack
    return patched


def altered_step(make):
    """Every step's output state scaled by 1.01."""
    def patched(*args, **kwargs):
        step, pack, unpack = make(*args, **kwargs)
        return (lambda u: step(u) * (1 + 1e-2) ** (1 / u.shape[0])), \
            pack, unpack
    return patched


FAULTS = {"unchanged": ("make_cn_step", unchanged_step),
          "altered": ("make_cn_step", altered_step)}
