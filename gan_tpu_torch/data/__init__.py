"""Host data path of the predict slice: listing, decode + nearest resize into
a uint8 cache, batching, and [-1, 1] normalization on the device."""
