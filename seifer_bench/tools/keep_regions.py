"""Imported, makes every traced run of this process keep the program's
regions (``lib/regions.install``).  ``tools/regions.py`` adds it to the
GPipe entry's fork-server preloads, so the ranks forked from the server
keep them too."""

from seifer_bench.lib import regions

regions.install()
