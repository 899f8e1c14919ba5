"""The benchmark of annlite_torch: cells of a configuration under a traffic
mix, driven through the ``AnnLite`` facade on one card (see README.md)."""
