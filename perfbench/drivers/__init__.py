"""Traffic generators: one module a traffic ``kind``, reading the mix's
parameters from `traffic/<name>.json`."""
