"""The wire format of ``Options``: a hand-written proto3 codec of
``nufft_options.proto`` (no protobuf dependency)."""
