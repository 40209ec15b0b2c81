# Vendored copy of cloudpickle 3.1.2 (BSD 3-Clause licence: LICENSE beside
# this file, and the header of cloudpickle.py), as Ray vendors it in
# python/ray/cloudpickle; the code is unchanged. The cluster runtime's
# serialization pickles with it, so the port needs no installed cloudpickle.
from . import cloudpickle
from .cloudpickle import *  # noqa

__doc__ = cloudpickle.__doc__

__version__ = "3.1.2"

__all__ = [  # noqa
    "__version__",
    "Pickler",
    "CloudPickler",
    "dumps",
    "loads",
    "dump",
    "load",
    "register_pickle_by_value",
    "unregister_pickle_by_value",
]
