"""The systems under test, one module per kind of configuration: each
makes the program's modules on the device from the seed (``System``) and
keeps float32 copies of their weights for the references."""
