"""The live FTPipeHD runtime of the port. Import from the submodules
(``runtime.live``, ``runtime.workload``, ...): importing this package
loads nothing, so the numpy-only modules stay light to import."""
