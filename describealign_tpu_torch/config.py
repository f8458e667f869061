"""Config system: config.ini persistence shared by GUI and CLI defaults (a
copy of describealign_tpu/config.py).

Same schema and behavior as the reference (describealign.py:1178-1197,
1493-1510, 1745-1760): one [alignment] section holding the 5 combine()
kwargs, stored via platformdirs with legacy-path migration (oldest ->
newest), auto-created with defaults on first read. The port has an
APP_NAME of its own, so its config.ini lives beside the JAX package's and
neither package's migrate_config moves or deletes the other's.
"""
import configparser
import os
import traceback
from pathlib import Path
from typing import Optional

from .constants import DEFAULT_ALIGNMENT_DIR, DEFAULT_OUTPUT_DIR

APP_NAME = 'describealign-tpu-torch'


def write_config_file(config_path, settings):
    config = configparser.ConfigParser()
    config.add_section('alignment')
    config['alignment'] = {}
    for key, value in settings.items():
        config['alignment'][key] = str(value)
    with open(config_path, 'w') as f:
        config.write(f)


def read_config_file(config_path):
    config = configparser.ConfigParser()
    config.read(config_path)
    settings = {
        'stretch_audio': config.getboolean('alignment', 'stretch_audio',
                                           fallback=False),
        'prepend': config.get('alignment', 'prepend', fallback='ad_'),
        'no_pitch_correction': config.getboolean(
            'alignment', 'no_pitch_correction', fallback=False),
        'output_dir': config.get('alignment', 'output_dir',
                                 fallback=DEFAULT_OUTPUT_DIR),
        'alignment_dir': config.get('alignment', 'alignment_dir',
                                    fallback=DEFAULT_ALIGNMENT_DIR),
    }
    if not config.has_section('alignment'):
        write_config_file(config_path, settings)
    return settings


def migrate_config(old_path: Optional[Path], new_path: Path) -> None:
    """Migrate configuration from an old location.

    Only runs if old_path exists but new_path does not.
    """
    if new_path.exists() or not old_path or not old_path.exists():
        return
    new_path.write_text(old_path.read_text(encoding='utf-8'),
                        encoding='utf-8')
    print(f"Configuration migrated to {new_path}")
    try:
        old_path.unlink()
    except OSError as exc:
        print("Failed to remove old config:",
              *traceback.format_exception_only(exc))
    else:
        print("Successfully removed old config file.")


def get_config_path():
    """Resolve (and migrate) the config.ini path."""
    try:
        import platformdirs
        config_path = platformdirs.user_config_path(
            appname=APP_NAME, appauthor=False, ensure_exists=True) / 'config.ini'
        old_paths = [
            # chronological order (oldest -> newest)
            Path(__file__).resolve().parent / 'config.ini',
            platformdirs.user_config_path(appname=APP_NAME,
                                          ensure_exists=True) / 'config.ini',
        ]
    except ImportError:
        config_dir = Path(os.path.expanduser('~')) / '.config' / APP_NAME
        config_dir.mkdir(parents=True, exist_ok=True)
        config_path = config_dir / 'config.ini'
        old_paths = [Path(__file__).resolve().parent / 'config.ini']
    old_config = next((f for f in reversed(old_paths) if f.exists()), None)
    try:
        migrate_config(old_config, config_path)
    except OSError as exc:
        print("Error migrating old config:",
              *traceback.format_exception_only(exc))
        print(f"Old config left in place at {old_config}")
    return config_path
