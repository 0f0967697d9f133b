"""Former name of the :mod:`bignn` package, kept so that existing imports and
``python -m <this package>.run`` keep working. New code imports ``bignn``.

Every ``<this package>.<sub>`` import resolves to the very module object of
``bignn.<sub>`` (one copy of each module and its state), and ``-m`` runs
that module's code.
"""

import importlib
import importlib.abc
import importlib.util
import sys

from bignn import __version__  # noqa: F401

_NEW = "bignn"


def _new_name(fullname: str) -> str:
    return _NEW + fullname[len(__name__):]


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(__name__ + "."):
            return None
        real = importlib.util.find_spec(_new_name(fullname))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None)

    def create_module(self, spec):
        module = importlib.import_module(_new_name(spec.name))
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system gave the module the alias spec; give it back
        # its own
        module.__spec__ = module.__spec__.loader_state

    def get_code(self, fullname):  # used by ``python -m``
        real = importlib.util.find_spec(_new_name(fullname))
        return real.loader.get_code(real.name)


sys.meta_path.insert(0, _Alias())
