"""altair constants: participation-flag indices/weights, sync subnets,
light-client generalized indices.

Reference parity: ethereum-consensus/src/altair/constants.rs and
src/altair/light_client.rs:10-17; a copy of
ethereum_consensus_tpu/models/altair/constants.py.
"""

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64

PARTICIPATION_FLAG_WEIGHTS = (
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
)

SYNC_COMMITTEE_SUBNET_COUNT = 4

# generalized indices into the altair BeaconState (light_client.rs:10-17)
FINALIZED_ROOT_INDEX = 105
FINALIZED_ROOT_INDEX_FLOOR_LOG_2 = 6
CURRENT_SYNC_COMMITTEE_INDEX = 54
CURRENT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2 = 5
NEXT_SYNC_COMMITTEE_INDEX = 55
NEXT_SYNC_COMMITTEE_INDEX_FLOOR_LOG_2 = 5
