"""The elastic driver's worker-side endpoints: rendezvous and
notifications."""
