"""The program's tracers, one module per ``tracer`` name a configuration
gives.  Each exposes ``build(cfg, seed)``: the configuration's finalized
eDAGs by trace name, made by the program from the seed."""
