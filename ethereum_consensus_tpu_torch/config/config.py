"""Runtime network configuration (the YAML `config.yaml` layer).

Reference parity: ethereum-consensus/src/configs/ (Config struct with
UPPERCASE-yaml serde, configs/mod.rs:12+, plus hard-coded mainnet/minimal/
goerli/sepolia/holesky constants, configs/mainnet.rs:7-38).

Built-in network values are transcribed from the public consensus-specs /
network metadata. Custom networks load from YAML via ``Config.from_yaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

from ..primitives import FAR_FUTURE_EPOCH

__all__ = ["Config", "mainnet_config", "minimal_config", "goerli_config",
           "sepolia_config", "holesky_config"]


def _hex(v: str) -> bytes:
    return bytes.fromhex(v.removeprefix("0x"))


@dataclass(frozen=True)
class Config:
    preset_base: str = "mainnet"
    name: str = "mainnet"

    # genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    genesis_delay: int = 604800

    # fork schedule
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int = FAR_FUTURE_EPOCH
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int = FAR_FUTURE_EPOCH
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    capella_fork_epoch: int = FAR_FUTURE_EPOCH
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: int = FAR_FUTURE_EPOCH
    electra_fork_version: bytes = b"\x05\x00\x00\x00"
    electra_fork_epoch: int = FAR_FUTURE_EPOCH

    # merge transition
    terminal_total_difficulty: int = 58750000000000000000000
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH

    # time
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048

    # validator cycle
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    ejection_balance: int = 16_000_000_000
    min_per_epoch_churn_limit: int = 4
    max_per_epoch_activation_churn_limit: int = 8
    churn_limit_quotient: int = 65536
    min_per_epoch_churn_limit_electra: int = 128_000_000_000
    max_per_epoch_activation_exit_churn_limit: int = 256_000_000_000

    # fork choice
    proposer_score_boost: int = 40

    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = _hex("00000000219ab540356cBB839Cbe05303d7705Fa".lower())

    @classmethod
    def from_yaml(cls, text: str) -> "Config":
        """Parse a consensus-specs style UPPERCASE config.yaml."""
        import yaml

        raw = yaml.safe_load(text) or {}
        kwargs = {}
        # field → byte length (YAML 1.1 parses bare 0x... scalars as ints,
        # so both hex-string and int forms must decode)
        byte_fields = {
            "genesis_fork_version": 4, "altair_fork_version": 4,
            "bellatrix_fork_version": 4, "capella_fork_version": 4,
            "deneb_fork_version": 4, "electra_fork_version": 4,
            "terminal_block_hash": 32, "deposit_contract_address": 20,
        }
        known = {f.name for f in fields(cls)}
        for key, value in raw.items():
            name = key.lower()
            if name == "config_name":
                name = "name"
            if name not in known:
                continue  # unknown keys are ignored (forward compat)
            if name in byte_fields:
                if isinstance(value, int):
                    kwargs[name] = value.to_bytes(byte_fields[name], "big")
                else:
                    kwargs[name] = _hex(str(value))
            elif name in ("preset_base", "name"):
                kwargs[name] = str(value)
            else:
                kwargs[name] = int(value)
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_yaml(f.read())


def mainnet_config() -> Config:
    return Config(
        altair_fork_epoch=74240,
        bellatrix_fork_epoch=144896,
        capella_fork_epoch=194048,
        deneb_fork_epoch=269568,
    )


def minimal_config() -> Config:
    return Config(
        preset_base="minimal",
        name="minimal",
        min_genesis_active_validator_count=64,
        min_genesis_time=1578009600,
        genesis_fork_version=b"\x00\x00\x00\x01",
        genesis_delay=300,
        altair_fork_version=b"\x01\x00\x00\x01",
        bellatrix_fork_version=b"\x02\x00\x00\x01",
        capella_fork_version=b"\x03\x00\x00\x01",
        deneb_fork_version=b"\x04\x00\x00\x01",
        electra_fork_version=b"\x05\x00\x00\x01",
        seconds_per_slot=6,
        eth1_follow_distance=16,
        shard_committee_period=64,
        min_per_epoch_churn_limit=2,
        max_per_epoch_activation_churn_limit=4,
        churn_limit_quotient=32,
        min_per_epoch_churn_limit_electra=64_000_000_000,
        max_per_epoch_activation_exit_churn_limit=128_000_000_000,
        deposit_chain_id=5,
        deposit_network_id=5,
        deposit_contract_address=_hex("1234567890123456789012345678901234567890"),
    )


def goerli_config() -> Config:
    return Config(
        name="goerli",
        min_genesis_time=1614588812,
        genesis_fork_version=_hex("00001020"),
        genesis_delay=1919188,
        altair_fork_version=_hex("01001020"),
        altair_fork_epoch=36660,
        bellatrix_fork_version=_hex("02001020"),
        bellatrix_fork_epoch=112260,
        capella_fork_version=_hex("03001020"),
        capella_fork_epoch=162304,
        deneb_fork_version=_hex("04001020"),
        deneb_fork_epoch=231680,
        terminal_total_difficulty=10790000,
        deposit_chain_id=5,
        deposit_network_id=5,
        deposit_contract_address=_hex("ff50ed3d0ec03ac01d4c79aad74928bff48a7b2b"),
    )


def sepolia_config() -> Config:
    return Config(
        name="sepolia",
        min_genesis_active_validator_count=1300,
        min_genesis_time=1655647200,
        genesis_fork_version=_hex("90000069"),
        genesis_delay=86400,
        altair_fork_version=_hex("90000070"),
        altair_fork_epoch=50,
        bellatrix_fork_version=_hex("90000071"),
        bellatrix_fork_epoch=100,
        capella_fork_version=_hex("90000072"),
        capella_fork_epoch=56832,
        deneb_fork_version=_hex("90000073"),
        deneb_fork_epoch=132608,
        terminal_total_difficulty=17000000000000000,
        deposit_chain_id=11155111,
        deposit_network_id=11155111,
        deposit_contract_address=_hex("7f02C3E3c98b133055B8B348B2Ac625669Ed295D".lower()),
    )


def holesky_config() -> Config:
    return Config(
        name="holesky",
        min_genesis_time=1695902100,
        genesis_fork_version=_hex("01017000"),
        genesis_delay=300,
        altair_fork_version=_hex("02017000"),
        altair_fork_epoch=0,
        bellatrix_fork_version=_hex("03017000"),
        bellatrix_fork_epoch=0,
        capella_fork_version=_hex("04017000"),
        capella_fork_epoch=256,
        deneb_fork_version=_hex("05017000"),
        deneb_fork_epoch=29696,
        ejection_balance=28_000_000_000,
        deposit_chain_id=17000,
        deposit_network_id=17000,
        deposit_contract_address=_hex("4242424242424242424242424242424242424242"),
    )
