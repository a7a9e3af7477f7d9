"""
Predefined example chemistries (parity with the reference's
`python/magicsoup/examples/`): Wood-Ljungdahl (the benchmark chemistry),
reverse Krebs, N2 fixation, and the combined CO2-fixation chemistry.
"""
