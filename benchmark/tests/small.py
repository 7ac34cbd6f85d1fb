"""Small sizes of every cell, for the benchmark's tests: the same
drivers, mixes and checks as the card's runs, at sizes a CPU test run
holds."""

SMALL = {
    "fanin_1k.cold_replay": {"config": {"writers": 20,
                                        "ops_per_writer": 100}},
    "tenants_1k.ycsb_d": {"config": {"recordcount": 60},
                          "mix": {"rate": 80, "check_reads": 30}},
}
