"""Reading a model's published `config.json` into a reference config class
with no key left silent.

Every published key is one of three kinds for the class that reads it:
a field of the class, which it builds from; an informational key
(`IGNORED`: bookkeeping, dtypes, versions, ids the reference never
uses), which it drops; or a fixed key (`FIXED`: a behaviour the
reference implements in one way only, such as `act_fn: silu`), which
has to hold that value.  Any other key, and a fixed key at
another value, raises: the reference would otherwise build a model other
than the one the configuration names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def read(cls, published: Dict[str, Any]):
    """An instance of the config dataclass `cls` from `published`, lists
    as tuples; `cls.IGNORED` names the informational keys and `cls.FIXED`
    maps each fixed key to the value the reference implements."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in published.items():
        if key in names:
            kwargs[key] = tuple(value) if isinstance(value, list) else value
        elif key in cls.FIXED:
            if value != cls.FIXED[key]:
                raise ValueError(
                    f"{cls.__name__}: the published {key}={value!r}; the "
                    f"reference implements {key}={cls.FIXED[key]!r} only")
        elif key not in cls.IGNORED:
            raise ValueError(f"{cls.__name__}: the published key {key!r} "
                             f"is neither read, informational nor fixed")
    return cls(**kwargs)
