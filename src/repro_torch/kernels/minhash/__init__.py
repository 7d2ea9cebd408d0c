"""Canonical k-mer hashing and minhash sketches (paper §V-C): ``ops`` holds
the ``kmer_hash`` kernel's wrappers, ``ref`` the plain versions."""
