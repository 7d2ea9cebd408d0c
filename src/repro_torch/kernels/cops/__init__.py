"""COPS probing kernels: ``ops`` holds the wrappers and plain versions."""
