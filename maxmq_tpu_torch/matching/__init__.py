"""Topic matching: CPU trie, signature tables, the device engine and the
matcher service. Import the submodules directly (``matching.sig``,
``matching.service``, ...); importing this package loads nothing."""
